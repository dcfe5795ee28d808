"""Matthews correlation coefficient metric classes (counterpart of
``metrics_tpu/classification/matthews_corrcoef.py``).

They inherit the confusion-matrix update, so in a collection they share its
compute group.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
    _confmat_dispatch,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce


class _MCCCompute:
    """Mixin: the MCC from the confusion-matrix state."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def compute(self) -> Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class BinaryMatthewsCorrCoef(_MCCCompute, BinaryConfusionMatrix):
    """Binary MCC."""

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True,
                 **kwargs: Any) -> None:
        super().__init__(threshold=threshold, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)


class MulticlassMatthewsCorrCoef(_MCCCompute, MulticlassConfusionMatrix):
    """Multiclass MCC."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True,
                 **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)


class MultilabelMatthewsCorrCoef(_MCCCompute, MultilabelConfusionMatrix):
    """Multilabel MCC: of the label matrices summed into one 2 x 2."""

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)


class MatthewsCorrCoef:
    """Task dispatcher: ``MatthewsCorrCoef(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _confmat_dispatch(
            task, BinaryMatthewsCorrCoef, MulticlassMatthewsCorrCoef, MultilabelMatthewsCorrCoef,
            threshold, num_classes, num_labels, kwargs,
        )
