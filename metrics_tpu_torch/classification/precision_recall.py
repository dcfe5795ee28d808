"""Precision / recall metric classes (counterpart of ``metrics_tpu/classification/precision_recall.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _task_dispatch,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce


class _Score:
    """Mixin: compute ``_stat`` ("precision" or "recall") from the stat-score state."""

    _stat = "precision"
    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        average = getattr(self, "average", "binary")
        return _precision_recall_reduce(self._stat, tp, fp, tn, fn, average=average, multidim_average=self.multidim_average)


class BinaryPrecision(_Score, BinaryStatScores):
    """Binary precision."""


class MulticlassPrecision(_Score, MulticlassStatScores):
    """Multiclass precision."""

    plot_legend_name: str = "Class"


class MultilabelPrecision(_Score, MultilabelStatScores):
    """Multilabel precision."""

    plot_legend_name: str = "Label"


class BinaryRecall(_Score, BinaryStatScores):
    """Binary recall."""

    _stat = "recall"


class MulticlassRecall(_Score, MulticlassStatScores):
    """Multiclass recall."""

    _stat = "recall"
    plot_legend_name: str = "Class"


class MultilabelRecall(_Score, MultilabelStatScores):
    """Multilabel recall."""

    _stat = "recall"
    plot_legend_name: str = "Label"


def _dispatch(binary, multiclass, multilabel, task, threshold, num_classes, num_labels, average, multidim_average,
              top_k, ignore_index, validate_args, kwargs) -> Metric:
    kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
    return _task_dispatch(
        task,
        binary,
        lambda c, k, **kw: multiclass(c, k, average, **kw),
        lambda n, t, **kw: multilabel(n, t, average, **kw),
        threshold, num_classes, num_labels, top_k, kwargs,
    )


class Precision:
    """Task dispatcher: ``Precision(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _dispatch(BinaryPrecision, MulticlassPrecision, MultilabelPrecision, task, threshold, num_classes,
                         num_labels, average, multidim_average, top_k, ignore_index, validate_args, kwargs)


class Recall:
    """Task dispatcher: ``Recall(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _dispatch(BinaryRecall, MulticlassRecall, MultilabelRecall, task, threshold, num_classes,
                         num_labels, average, multidim_average, top_k, ignore_index, validate_args, kwargs)
