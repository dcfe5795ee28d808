"""Jaccard index metric classes (counterpart of ``metrics_tpu/classification/jaccard.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
    _confmat_dispatch,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_index_reduce


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary Jaccard index."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, average="binary")


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass Jaccard index (mean IoU with the default macro average)."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def __init__(self, num_classes: int, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)
        self.average = average

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, average=self.average, ignore_index=self.ignore_index)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Multilabel Jaccard index."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)
        self.average = average

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, average=self.average, ignore_index=self.ignore_index)


class JaccardIndex:
    """Task dispatcher: ``JaccardIndex(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _confmat_dispatch(
            task,
            BinaryJaccardIndex,
            lambda c, **kw: MulticlassJaccardIndex(c, average, **kw),
            lambda n, t, **kw: MultilabelJaccardIndex(n, t, average, **kw),
            threshold, num_classes, num_labels, kwargs,
        )
