"""Root-functional shims of the image functionals (counterpart of
``metrics_tpu/functional/image/_deprecated.py``): called as
``metrics_tpu_torch.functional.<name>`` they warn (``FutureWarning``); from
``metrics_tpu_torch.functional.image`` they stay silent.
"""
from metrics_tpu_torch.functional.image import (
    error_relative_global_dimensionless_synthesis,
    image_gradients,
    multiscale_structural_similarity_index_measure,
    peak_signal_noise_ratio,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spectral_angle_mapper,
    spectral_distortion_index,
    structural_similarity_index_measure,
    total_variation,
    universal_image_quality_index,
)
from metrics_tpu_torch.utils.prints import _root_func_shim

_error_relative_global_dimensionless_synthesis = _root_func_shim(
    error_relative_global_dimensionless_synthesis, "error_relative_global_dimensionless_synthesis", "image"
)
_image_gradients = _root_func_shim(image_gradients, "image_gradients", "image")
_multiscale_structural_similarity_index_measure = _root_func_shim(
    multiscale_structural_similarity_index_measure, "multiscale_structural_similarity_index_measure", "image"
)
_peak_signal_noise_ratio = _root_func_shim(peak_signal_noise_ratio, "peak_signal_noise_ratio", "image")
_relative_average_spectral_error = _root_func_shim(
    relative_average_spectral_error, "relative_average_spectral_error", "image"
)
_root_mean_squared_error_using_sliding_window = _root_func_shim(
    root_mean_squared_error_using_sliding_window, "root_mean_squared_error_using_sliding_window", "image"
)
_spectral_angle_mapper = _root_func_shim(spectral_angle_mapper, "spectral_angle_mapper", "image")
_spectral_distortion_index = _root_func_shim(spectral_distortion_index, "spectral_distortion_index", "image")
_structural_similarity_index_measure = _root_func_shim(
    structural_similarity_index_measure, "structural_similarity_index_measure", "image"
)
_total_variation = _root_func_shim(total_variation, "total_variation", "image")
_universal_image_quality_index = _root_func_shim(universal_image_quality_index, "universal_image_quality_index", "image")

__all__ = [
    "_error_relative_global_dimensionless_synthesis",
    "_image_gradients",
    "_multiscale_structural_similarity_index_measure",
    "_peak_signal_noise_ratio",
    "_relative_average_spectral_error",
    "_root_mean_squared_error_using_sliding_window",
    "_spectral_angle_mapper",
    "_spectral_distortion_index",
    "_structural_similarity_index_measure",
    "_total_variation",
    "_universal_image_quality_index",
]
