"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu, for NVIDIA Hopper.

Same public names and state contract as ``metrics_tpu``; entry points run on the
card (``cuda``) unless the caller asks for another device. Kernels written by hand
live under ``csrc/`` and build at first use into ``build/kernels/``.

The package root exports what ``metrics_tpu``'s root exports of the ported
families: the classification classes, ``MetricCollection``, ``CompositionalMetric``,
the aggregators and ``functional``; the retrieval classes through shims that warn
(``FutureWarning``) as the JAX package's do. Families not ported yet are absent.
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
    "CompositionalMetric", "ConfusionMatrix", "Dice", "ExactMatch", "F1Score", "FBetaScore", "HammingDistance",
    "HingeLoss", "JaccardIndex", "MatthewsCorrCoef", "MaxMetric", "MeanMetric", "Metric", "MetricCollection",
    "MinMetric", "MulticlassAUROC", "MulticlassAccuracy", "MulticlassAveragePrecision", "MulticlassCohenKappa",
    "MulticlassConfusionMatrix", "MulticlassJaccardIndex", "MulticlassMatthewsCorrCoef",
    "MulticlassPrecisionRecallCurve", "MulticlassROC", "MulticlassStatScores", "MultilabelAUROC",
    "MultilabelAccuracy", "MultilabelAveragePrecision", "MultilabelConfusionMatrix", "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef", "MultilabelPrecisionRecallCurve", "MultilabelROC", "MultilabelStatScores",
    "Precision", "PrecisionAtFixedRecall", "PrecisionRecallCurve", "ROC", "Recall", "RecallAtFixedPrecision",
    "RetrievalFallOut", "RetrievalHitRate", "RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG",
    "RetrievalPrecision", "RetrievalPrecisionRecallCurve", "RetrievalRPrecision", "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision", "Specificity", "StatScores", "SumMetric", "functional",
]
