"""Multilabel ranking metric classes (counterpart of ``metrics_tpu/classification/ranking.py``).

States: the summed per-sample ``measure`` (float32) and the sample count ``total``
(int64), both reduced by sum.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
)
from metrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
    _ranking_reduce,
)
from metrics_tpu_torch.utils.data import _count_dtype


class _MultilabelRankingMetric(Metric):
    """The shared states and update of the three ranking metrics."""

    is_differentiable: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _update_fn = None  # set per subclass

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, threshold=0.0, ignore_index=self.ignore_index, should_threshold=False
        )
        measure, total = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _ranking_reduce(self.measure, self.total)


class MultilabelCoverageError(_MultilabelRankingMetric):
    """Multilabel coverage error: how far down the ranking all relevant labels reach."""

    higher_is_better: bool = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingMetric):
    """Multilabel label-ranking average precision."""

    higher_is_better: bool = True
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingMetric):
    """Multilabel ranking loss: the share of wrongly ordered (relevant, irrelevant) pairs."""

    higher_is_better: bool = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
