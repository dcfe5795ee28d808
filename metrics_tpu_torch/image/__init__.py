"""Image metrics of metrics_tpu_torch (counterpart of ``metrics_tpu.image``).

Every class of the JAX package but ``LearnedPerceptualImagePatchSimilarity``, whose
backbones need local weight files that are not ported yet.
"""
from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from metrics_tpu_torch.image.fid import FrechetInceptionDistance
from metrics_tpu_torch.image.inception import InceptionScore
from metrics_tpu_torch.image.kid import KernelInceptionDistance
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.psnrb import PeakSignalNoiseRatioWithBlockedEffect
from metrics_tpu_torch.image.rase import RelativeAverageSpectralError
from metrics_tpu_torch.image.rmse_sw import RootMeanSquaredErrorUsingSlidingWindow
from metrics_tpu_torch.image.sam import SpectralAngleMapper
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.tv import TotalVariation
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
]
