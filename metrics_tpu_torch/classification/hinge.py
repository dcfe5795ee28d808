"""Hinge loss metric classes (counterpart of ``metrics_tpu/classification/hinge.py``).

States: the summed margins ``measures`` (a float32 scalar, or one per class for
one-vs-all) and the sample count ``total`` (int64), both reduced by sum.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _multiclass_confusion_matrix_format,
)
from metrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_loss_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_tensor_validation,
    _multiclass_hinge_loss_update,
)
from metrics_tpu_torch.utils.data import _count_dtype
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _HingeLossBase(Metric):
    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def _init_states(self, measures_shape) -> None:
        self.add_state("measures", torch.zeros(measures_shape, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def _accumulate(self, measures: Tensor, total: Tensor) -> None:
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hinge_loss_compute(self.measures, self.total)


class BinaryHingeLoss(_HingeLossBase):
    """Mean binary hinge loss (squared or not)."""

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_states(())

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(
            preds, target, threshold=0.0, ignore_index=self.ignore_index, convert_to_labels=False
        )
        self._accumulate(*_binary_hinge_loss_update(preds, target, self.squared))


class MulticlassHingeLoss(_HingeLossBase):
    """Mean multiclass hinge loss, Crammer-Singer (a scalar) or one-vs-all (one per class)."""

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_states(() if multiclass_mode == "crammer-singer" else (num_classes,))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_hinge_loss_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(preds, target, self.ignore_index, convert_to_labels=False)
        self._accumulate(*_multiclass_hinge_loss_update(preds, target, self.squared, self.multiclass_mode))


class HingeLoss:
    """Task dispatcher."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
        raise ValueError(f"Not handled value: {task}")
