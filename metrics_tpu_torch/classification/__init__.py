from metrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from metrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from metrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from metrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.classification.exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
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
from metrics_tpu_torch.classification.hamming import (
    BinaryHammingDistance,
    HammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
)
from metrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from metrics_tpu_torch.classification.matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
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
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from metrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from metrics_tpu_torch.classification.specificity import (
    BinarySpecificity,
    MulticlassSpecificity,
    MultilabelSpecificity,
    Specificity,
)
from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

from metrics_tpu_torch.classification.calibration_error import (
    BinaryCalibrationError,
    CalibrationError,
    MulticlassCalibrationError,
)
from metrics_tpu_torch.classification.dice import (
    Dice,
)
from metrics_tpu_torch.classification.group_fairness import (
    BinaryFairness,
    BinaryGroupStatRates,
)
from metrics_tpu_torch.classification.hinge import (
    BinaryHingeLoss,
    HingeLoss,
    MulticlassHingeLoss,
)
from metrics_tpu_torch.classification.precision_fixed_recall import (
    BinaryPrecisionAtFixedRecall,
    MulticlassPrecisionAtFixedRecall,
    MultilabelPrecisionAtFixedRecall,
    PrecisionAtFixedRecall,
)
from metrics_tpu_torch.classification.ranking import (
    MultilabelCoverageError,
    MultilabelRankingAveragePrecision,
    MultilabelRankingLoss,
)
from metrics_tpu_torch.classification.recall_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    RecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.specificity_sensitivity import (
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    SpecificityAtSensitivity,
)

__all__ = [
    "Accuracy", "BinaryAccuracy", "MulticlassAccuracy", "MultilabelAccuracy",
    "AUROC", "BinaryAUROC", "MulticlassAUROC", "MultilabelAUROC",
    "AveragePrecision", "BinaryAveragePrecision", "MulticlassAveragePrecision", "MultilabelAveragePrecision",
    "BinaryCohenKappa", "CohenKappa", "MulticlassCohenKappa",
    "BinaryConfusionMatrix", "ConfusionMatrix", "MulticlassConfusionMatrix", "MultilabelConfusionMatrix",
    "ExactMatch", "MulticlassExactMatch", "MultilabelExactMatch",
    "BinaryF1Score", "BinaryFBetaScore", "F1Score", "FBetaScore", "MulticlassF1Score", "MulticlassFBetaScore",
    "MultilabelF1Score", "MultilabelFBetaScore",
    "BinaryHammingDistance", "HammingDistance", "MulticlassHammingDistance", "MultilabelHammingDistance",
    "BinaryJaccardIndex", "JaccardIndex", "MulticlassJaccardIndex", "MultilabelJaccardIndex",
    "BinaryMatthewsCorrCoef", "MatthewsCorrCoef", "MulticlassMatthewsCorrCoef", "MultilabelMatthewsCorrCoef",
    "BinaryPrecision", "BinaryRecall", "MulticlassPrecision", "MulticlassRecall", "MultilabelPrecision",
    "MultilabelRecall", "Precision", "Recall",
    "BinaryPrecisionRecallCurve", "MulticlassPrecisionRecallCurve", "MultilabelPrecisionRecallCurve",
    "PrecisionRecallCurve",
    "BinaryROC", "MulticlassROC", "MultilabelROC", "ROC",
    "BinarySpecificity", "MulticlassSpecificity", "MultilabelSpecificity", "Specificity",
    "BinaryStatScores", "MulticlassStatScores", "MultilabelStatScores", "StatScores",
    "BinaryCalibrationError", "CalibrationError", "MulticlassCalibrationError",
    "Dice",
    "BinaryFairness", "BinaryGroupStatRates",
    "BinaryHingeLoss", "HingeLoss", "MulticlassHingeLoss",
    "BinaryPrecisionAtFixedRecall", "MulticlassPrecisionAtFixedRecall", "MultilabelPrecisionAtFixedRecall",
    "PrecisionAtFixedRecall",
    "MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss",
    "BinaryRecallAtFixedPrecision", "MulticlassRecallAtFixedPrecision", "MultilabelRecallAtFixedPrecision",
    "RecallAtFixedPrecision",
    "BinarySpecificityAtSensitivity", "MulticlassSpecificityAtSensitivity", "MultilabelSpecificityAtSensitivity",
    "SpecificityAtSensitivity",
]
