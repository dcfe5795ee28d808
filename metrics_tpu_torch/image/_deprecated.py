"""Root-import shims of the image metrics (counterpart of ``metrics_tpu/image/_deprecated.py``):
built from the package root they warn (``FutureWarning``); from
``metrics_tpu_torch.image`` they stay silent.
"""
from metrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.utils.prints import _root_class_shim

_ErrorRelativeGlobalDimensionlessSynthesis = _root_class_shim(
    ErrorRelativeGlobalDimensionlessSynthesis, "ErrorRelativeGlobalDimensionlessSynthesis", "image", __name__
)
_MultiScaleStructuralSimilarityIndexMeasure = _root_class_shim(
    MultiScaleStructuralSimilarityIndexMeasure, "MultiScaleStructuralSimilarityIndexMeasure", "image", __name__
)
_PeakSignalNoiseRatio = _root_class_shim(PeakSignalNoiseRatio, "PeakSignalNoiseRatio", "image", __name__)
_RelativeAverageSpectralError = _root_class_shim(
    RelativeAverageSpectralError, "RelativeAverageSpectralError", "image", __name__
)
_RootMeanSquaredErrorUsingSlidingWindow = _root_class_shim(
    RootMeanSquaredErrorUsingSlidingWindow, "RootMeanSquaredErrorUsingSlidingWindow", "image", __name__
)
_SpectralAngleMapper = _root_class_shim(SpectralAngleMapper, "SpectralAngleMapper", "image", __name__)
_SpectralDistortionIndex = _root_class_shim(SpectralDistortionIndex, "SpectralDistortionIndex", "image", __name__)
_StructuralSimilarityIndexMeasure = _root_class_shim(
    StructuralSimilarityIndexMeasure, "StructuralSimilarityIndexMeasure", "image", __name__
)
_TotalVariation = _root_class_shim(TotalVariation, "TotalVariation", "image", __name__)
_UniversalImageQualityIndex = _root_class_shim(UniversalImageQualityIndex, "UniversalImageQualityIndex", "image", __name__)

__all__ = [
    "_ErrorRelativeGlobalDimensionlessSynthesis",
    "_MultiScaleStructuralSimilarityIndexMeasure",
    "_PeakSignalNoiseRatio",
    "_RelativeAverageSpectralError",
    "_RootMeanSquaredErrorUsingSlidingWindow",
    "_SpectralAngleMapper",
    "_SpectralDistortionIndex",
    "_StructuralSimilarityIndexMeasure",
    "_TotalVariation",
    "_UniversalImageQualityIndex",
]
