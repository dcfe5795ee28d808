"""Hamming distance metric classes (counterpart of ``metrics_tpu/classification/hamming.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _dispatch
from metrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_reduce


class _HammingCompute:
    """Mixin: the Hamming distance from the stat-score state."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _multilabel = False

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        average = getattr(self, "average", "binary")
        return _hamming_distance_reduce(
            tp, fp, tn, fn, average=average, multidim_average=self.multidim_average, multilabel=self._multilabel
        )


class BinaryHammingDistance(_HammingCompute, BinaryStatScores):
    """Binary Hamming distance: the share of wrong predictions."""


class MulticlassHammingDistance(_HammingCompute, MulticlassStatScores):
    """Multiclass Hamming distance."""

    plot_legend_name: str = "Class"


class MultilabelHammingDistance(_HammingCompute, MultilabelStatScores):
    """Multilabel Hamming distance."""

    plot_legend_name: str = "Label"
    _multilabel = True


class HammingDistance:
    """Task dispatcher: ``HammingDistance(task=...)`` returns the matching class."""

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
        return _dispatch(BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance, task, threshold,
                         num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args, kwargs)
