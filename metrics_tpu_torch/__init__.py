"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu, for NVIDIA Hopper.

Same public names and state contract as ``metrics_tpu``; entry points run on the
card (``cuda``) unless the caller asks for another device. Kernels written by hand
live under ``csrc/`` and build at first use into ``build/kernels/``.

The package root exports what ``metrics_tpu``'s root exports of the ported
families: the classification classes, ``MetricCollection``, ``CompositionalMetric``,
the aggregators and ``functional``; the retrieval classes through shims that warn
(``FutureWarning``) as the JAX package's do; the image classes as the JAX root does
(FID, KID, IS and PSNRB directly, the others through warning shims); the detection
classes as the JAX root does (the panoptic two through warning shims). Families not
ported yet, and LPIPS, are absent.
"""
from metrics_tpu_torch import functional
from metrics_tpu_torch.classification import (
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinaryAccuracy,
    BinaryAUROC,
    BinaryAveragePrecision,
    BinaryCohenKappa,
    BinaryConfusionMatrix,
    BinaryJaccardIndex,
    BinaryMatthewsCorrCoef,
    BinaryPrecisionRecallCurve,
    BinaryROC,
    BinaryStatScores,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    Dice,
    ExactMatch,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    MatthewsCorrCoef,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassAveragePrecision,
    MulticlassCohenKappa,
    MulticlassConfusionMatrix,
    MulticlassJaccardIndex,
    MulticlassMatthewsCorrCoef,
    MulticlassPrecisionRecallCurve,
    MulticlassROC,
    MulticlassStatScores,
    MultilabelAccuracy,
    MultilabelAUROC,
    MultilabelAveragePrecision,
    MultilabelConfusionMatrix,
    MultilabelJaccardIndex,
    MultilabelMatthewsCorrCoef,
    MultilabelPrecisionRecallCurve,
    MultilabelROC,
    MultilabelStatScores,
    Precision,
    PrecisionAtFixedRecall,
    PrecisionRecallCurve,
    Recall,
    RecallAtFixedPrecision,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.core.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric
from metrics_tpu_torch.detection import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
    MeanAveragePrecision,
)
from metrics_tpu_torch.detection._deprecated import (
    _ModifiedPanopticQuality as ModifiedPanopticQuality,
    _PanopticQuality as PanopticQuality,
)
from metrics_tpu_torch.image import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    PeakSignalNoiseRatioWithBlockedEffect,
)
from metrics_tpu_torch.image._deprecated import (
    _ErrorRelativeGlobalDimensionlessSynthesis as ErrorRelativeGlobalDimensionlessSynthesis,
    _MultiScaleStructuralSimilarityIndexMeasure as MultiScaleStructuralSimilarityIndexMeasure,
    _PeakSignalNoiseRatio as PeakSignalNoiseRatio,
    _RelativeAverageSpectralError as RelativeAverageSpectralError,
    _RootMeanSquaredErrorUsingSlidingWindow as RootMeanSquaredErrorUsingSlidingWindow,
    _SpectralAngleMapper as SpectralAngleMapper,
    _SpectralDistortionIndex as SpectralDistortionIndex,
    _StructuralSimilarityIndexMeasure as StructuralSimilarityIndexMeasure,
    _TotalVariation as TotalVariation,
    _UniversalImageQualityIndex as UniversalImageQualityIndex,
)
from metrics_tpu_torch.retrieval._deprecated import (
    _RetrievalFallOut as RetrievalFallOut,
    _RetrievalHitRate as RetrievalHitRate,
    _RetrievalMAP as RetrievalMAP,
    _RetrievalMRR as RetrievalMRR,
    _RetrievalNormalizedDCG as RetrievalNormalizedDCG,
    _RetrievalPrecision as RetrievalPrecision,
    _RetrievalPrecisionRecallCurve as RetrievalPrecisionRecallCurve,
    _RetrievalRecall as RetrievalRecall,
    _RetrievalRecallAtFixedPrecision as RetrievalRecallAtFixedPrecision,
    _RetrievalRPrecision as RetrievalRPrecision,
)

__all__ = [
    "AUROC", "Accuracy", "AveragePrecision", "BinaryAUROC", "BinaryAccuracy", "BinaryAveragePrecision",
    "BinaryCohenKappa", "BinaryConfusionMatrix", "BinaryJaccardIndex", "BinaryMatthewsCorrCoef",
    "BinaryPrecisionRecallCurve", "BinaryROC", "BinaryStatScores", "CalibrationError", "CatMetric", "CohenKappa",
    "CompleteIntersectionOverUnion", "CompositionalMetric", "ConfusionMatrix", "Dice",
    "DistanceIntersectionOverUnion", "ErrorRelativeGlobalDimensionlessSynthesis", "ExactMatch", "F1Score",
    "FBetaScore", "FrechetInceptionDistance", "GeneralizedIntersectionOverUnion", "HammingDistance", "HingeLoss",
    "InceptionScore", "IntersectionOverUnion", "JaccardIndex", "KernelInceptionDistance", "MatthewsCorrCoef",
    "MaxMetric", "MeanAveragePrecision", "MeanMetric", "Metric", "MetricCollection", "MinMetric",
    "ModifiedPanopticQuality", "MultiScaleStructuralSimilarityIndexMeasure", "MulticlassAUROC",
    "MulticlassAccuracy", "MulticlassAveragePrecision", "MulticlassCohenKappa", "MulticlassConfusionMatrix",
    "MulticlassJaccardIndex", "MulticlassMatthewsCorrCoef", "MulticlassPrecisionRecallCurve", "MulticlassROC",
    "MulticlassStatScores", "MultilabelAUROC", "MultilabelAccuracy", "MultilabelAveragePrecision",
    "MultilabelConfusionMatrix", "MultilabelJaccardIndex", "MultilabelMatthewsCorrCoef",
    "MultilabelPrecisionRecallCurve", "MultilabelROC", "MultilabelStatScores", "PanopticQuality",
    "PeakSignalNoiseRatio", "PeakSignalNoiseRatioWithBlockedEffect", "Precision", "PrecisionAtFixedRecall",
    "PrecisionRecallCurve", "ROC", "Recall", "RecallAtFixedPrecision", "RelativeAverageSpectralError",
    "RetrievalFallOut", "RetrievalHitRate", "RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG",
    "RetrievalPrecision", "RetrievalPrecisionRecallCurve", "RetrievalRPrecision", "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision", "RootMeanSquaredErrorUsingSlidingWindow", "SpectralAngleMapper",
    "SpectralDistortionIndex", "Specificity", "StatScores", "StructuralSimilarityIndexMeasure", "SumMetric",
    "TotalVariation", "UniversalImageQualityIndex", "functional",
]
