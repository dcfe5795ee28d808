"""Image functionals of metrics_tpu_torch (counterpart of ``metrics_tpu.functional.image``).

Every name of the JAX package but ``learned_perceptual_image_patch_similarity``,
whose backbones need local weight files that are not ported yet.
"""
from metrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from metrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis
from metrics_tpu_torch.functional.image.gradients import image_gradients
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.psnrb import peak_signal_noise_ratio_with_blocked_effect
from metrics_tpu_torch.functional.image.rase import relative_average_spectral_error
from metrics_tpu_torch.functional.image.rmse_sw import root_mean_squared_error_using_sliding_window
from metrics_tpu_torch.functional.image.sam import spectral_angle_mapper
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.functional.image.tv import total_variation
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
]
