"""Specificity metric classes (counterpart of ``metrics_tpu/classification/specificity.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _dispatch
from metrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.specificity import _specificity_reduce


class _SpecificityCompute:
    """Mixin: specificity from the stat-score state."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        average = getattr(self, "average", "binary")
        return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=self.multidim_average)


class BinarySpecificity(_SpecificityCompute, BinaryStatScores):
    """Binary specificity: tn / (tn + fp)."""


class MulticlassSpecificity(_SpecificityCompute, MulticlassStatScores):
    """Multiclass specificity, one-vs-rest per class, then averaged."""

    plot_legend_name: str = "Class"


class MultilabelSpecificity(_SpecificityCompute, MultilabelStatScores):
    """Multilabel specificity, per label, then averaged."""

    plot_legend_name: str = "Label"


class Specificity:
    """Task dispatcher: ``Specificity(task=...)`` returns the matching class."""

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
        return _dispatch(BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, task, threshold, num_classes,
                         num_labels, average, multidim_average, top_k, ignore_index, validate_args, kwargs)
