"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu, for NVIDIA Hopper.

Same public names and state contract as ``metrics_tpu``; entry points run on the
card (``cuda``) unless the caller asks for another device. Kernels written by hand
live under ``csrc/`` and build at first use into ``build/kernels/``.

The package root exports what ``metrics_tpu``'s root exports of the ported
families: the classification classes, ``MetricCollection``, ``CompositionalMetric``,
the aggregators and ``functional``; the retrieval classes through shims that warn
(``FutureWarning``) as the JAX package's do; the image classes as the JAX root does
(FID, KID, IS and PSNRB directly, the others through warning shims); the detection
classes as the JAX root does (the panoptic two through warning shims); the regression
classes, the audio classes as the JAX root does (PESQ and STOI directly, the other
five through warning shims), the nominal classes, the wrappers, the four sketches, and
the text classes as the JAX root does (ROUGEScore directly, the other twelve through
warning shims), BERTScore, InfoLM, CLIPScore and LPIPS directly, as the JAX root does.
"""
from metrics_tpu_torch import functional
from metrics_tpu_torch.audio import PerceptualEvaluationSpeechQuality, ShortTimeObjectiveIntelligibility
from metrics_tpu_torch.audio._deprecated import (
    _PermutationInvariantTraining as PermutationInvariantTraining,
    _ScaleInvariantSignalDistortionRatio as ScaleInvariantSignalDistortionRatio,
    _ScaleInvariantSignalNoiseRatio as ScaleInvariantSignalNoiseRatio,
    _SignalDistortionRatio as SignalDistortionRatio,
    _SignalNoiseRatio as SignalNoiseRatio,
)
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
    LearnedPerceptualImagePatchSimilarity,
    PeakSignalNoiseRatioWithBlockedEffect,
)
from metrics_tpu_torch.multimodal import CLIPScore
from metrics_tpu_torch.nominal import CramersV, PearsonsContingencyCoefficient, TheilsU, TschuprowsT
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
from metrics_tpu_torch.regression import (
    ConcordanceCorrCoef,
    CosineSimilarity,
    ExplainedVariance,
    KendallRankCorrCoef,
    KLDivergence,
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    MinkowskiDistance,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
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
from metrics_tpu_torch.sketches import DistinctCount, HistogramDrift, QuantileSketch, StreamingAUROCBound
from metrics_tpu_torch.text import BERTScore, InfoLM, ROUGEScore
from metrics_tpu_torch.text._deprecated import (
    _BLEUScore as BLEUScore,
    _CharErrorRate as CharErrorRate,
    _CHRFScore as CHRFScore,
    _ExtendedEditDistance as ExtendedEditDistance,
    _MatchErrorRate as MatchErrorRate,
    _Perplexity as Perplexity,
    _SacreBLEUScore as SacreBLEUScore,
    _SQuAD as SQuAD,
    _TranslationEditRate as TranslationEditRate,
    _WordErrorRate as WordErrorRate,
    _WordInfoLost as WordInfoLost,
    _WordInfoPreserved as WordInfoPreserved,
)
from metrics_tpu_torch.wrappers import BootStrapper, ClasswiseWrapper, MetricTracker, MinMaxMetric, MultioutputWrapper

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
    # regression and audio
    "ConcordanceCorrCoef", "CosineSimilarity", "ExplainedVariance", "KLDivergence", "KendallRankCorrCoef",
    "LogCoshError", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanSquaredError", "MeanSquaredLogError",
    "MinkowskiDistance", "PearsonCorrCoef", "PerceptualEvaluationSpeechQuality", "PermutationInvariantTraining",
    "R2Score", "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility", "SignalDistortionRatio", "SignalNoiseRatio", "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError", "TweedieDevianceScore", "WeightedMeanAbsolutePercentageError",
    # nominal and wrappers
    "CramersV", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT",
    "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper",
    # sketches
    "DistinctCount", "HistogramDrift", "QuantileSketch", "StreamingAUROCBound",
    # text
    "BLEUScore", "CHRFScore", "CharErrorRate", "ExtendedEditDistance", "MatchErrorRate", "Perplexity", "ROUGEScore",
    "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WordErrorRate", "WordInfoLost", "WordInfoPreserved",
    # the model metrics
    "BERTScore", "CLIPScore", "InfoLM", "LearnedPerceptualImagePatchSimilarity",
]
