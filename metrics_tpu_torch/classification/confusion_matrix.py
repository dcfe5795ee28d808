"""Confusion-matrix metric classes (counterpart of ``metrics_tpu/classification/confusion_matrix.py``).

State: one int64 ``sum`` confusion matrix (2x2, CxC or Lx2x2).
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_compute,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_compute,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from metrics_tpu_torch.utils.data import _count_dtype
from metrics_tpu_torch.utils.enums import ClassificationTask


class _ConfusionMatrixPlotMixin:
    """The heatmap plot of the three confusion-matrix tasks."""

    def plot(self, val=None, ax=None, add_text=True, labels=None):
        """Heatmap of the confusion matrix (``compute()`` by default). Returns
        ``(figure, axes)``."""
        from metrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class BinaryConfusionMatrix(_ConfusionMatrixPlotMixin, Metric):
    """2x2 confusion matrix."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("threshold", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target)

    def compute(self) -> Tensor:
        return _binary_confusion_matrix_compute(self.confmat, self.normalize)


class MulticlassConfusionMatrix(_ConfusionMatrixPlotMixin, Metric):
    """C x C confusion matrix; one histogram kernel launch per update on the card."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_classes", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, self.num_classes)

    def compute(self) -> Tensor:
        return _multiclass_confusion_matrix_compute(self.confmat, self.normalize)


class MultilabelConfusionMatrix(_ConfusionMatrixPlotMixin, Metric):
    """(L, 2, 2) confusion matrices."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_labels", "threshold", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=_count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, self.num_labels)

    def compute(self) -> Tensor:
        return _multilabel_confusion_matrix_compute(self.confmat, self.normalize)


def _confmat_dispatch(task, binary, multiclass, multilabel, threshold, num_classes, num_labels, kwargs) -> Metric:
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass(num_classes, **kwargs)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel(num_labels, threshold, **kwargs)
    raise ValueError(f"Not handled value: {task}")


class ConfusionMatrix:
    """Task dispatcher: ``ConfusionMatrix(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        return _confmat_dispatch(
            task, BinaryConfusionMatrix, MulticlassConfusionMatrix, MultilabelConfusionMatrix,
            threshold, num_classes, num_labels, kwargs,
        )
