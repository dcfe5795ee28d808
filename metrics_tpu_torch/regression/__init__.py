"""Regression metrics (counterpart of ``metrics_tpu/regression/__init__.py``)."""
from metrics_tpu_torch.regression.concordance import ConcordanceCorrCoef
from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance
from metrics_tpu_torch.regression.kendall import KendallRankCorrCoef
from metrics_tpu_torch.regression.kl_divergence import KLDivergence
from metrics_tpu_torch.regression.log_cosh import LogCoshError
from metrics_tpu_torch.regression.log_mse import MeanSquaredLogError
from metrics_tpu_torch.regression.mae import MeanAbsoluteError
from metrics_tpu_torch.regression.mape import MeanAbsolutePercentageError
from metrics_tpu_torch.regression.minkowski import MinkowskiDistance
from metrics_tpu_torch.regression.mse import MeanSquaredError
from metrics_tpu_torch.regression.pearson import PearsonCorrCoef
from metrics_tpu_torch.regression.r2 import R2Score
from metrics_tpu_torch.regression.spearman import SpearmanCorrCoef
from metrics_tpu_torch.regression.symmetric_mape import SymmetricMeanAbsolutePercentageError
from metrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore
from metrics_tpu_torch.regression.wmape import WeightedMeanAbsolutePercentageError

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
