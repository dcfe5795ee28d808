from metrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from metrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from metrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "Accuracy", "BinaryAccuracy", "MulticlassAccuracy", "MultilabelAccuracy",
    "BinaryConfusionMatrix", "ConfusionMatrix", "MulticlassConfusionMatrix", "MultilabelConfusionMatrix",
    "BinaryF1Score", "BinaryFBetaScore", "F1Score", "FBetaScore", "MulticlassF1Score", "MulticlassFBetaScore",
    "MultilabelF1Score", "MultilabelFBetaScore",
    "BinaryJaccardIndex", "JaccardIndex", "MulticlassJaccardIndex", "MultilabelJaccardIndex",
    "BinaryPrecision", "BinaryRecall", "MulticlassPrecision", "MulticlassRecall", "MultilabelPrecision",
    "MultilabelRecall", "Precision", "Recall",
    "BinaryStatScores", "MulticlassStatScores", "MultilabelStatScores", "StatScores",
]
