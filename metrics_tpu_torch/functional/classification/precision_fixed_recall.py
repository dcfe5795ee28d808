"""Precision-at-fixed-recall functionals (counterpart of
``metrics_tpu/functional/classification/precision_fixed_recall.py``): the
recall-at-precision reduce with the two roles swapped, on the same device cascade.
"""
from typing import List, Optional, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _lexicographic_best,
    _multiclass_recall_at_fixed_precision_arg_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_arg_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.utils.enums import ClassificationTask


def _precision_at_recall(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_recall: float,
    point: Optional[Tensor] = None,
    descending: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Max precision (then recall, then threshold) with recall >= ``min_recall``."""
    return _lexicographic_best(precision, recall, thresholds, min_recall, point, descending)


def binary_precision_at_fixed_recall(
    preds,
    target,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Highest precision with recall >= ``min_recall``, and its threshold (binary)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_recall, reduce_fn=_precision_at_recall)


def multiclass_precision_at_fixed_recall(
    preds,
    target,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest precision with recall >= ``min_recall`` (one-vs-rest)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_recall_at_fixed_precision_arg_compute(
        state, num_classes, thresholds, min_recall, reduce_fn=_precision_at_recall
    )


def multilabel_precision_at_fixed_recall(
    preds,
    target,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest precision with recall >= ``min_recall``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_recall_at_fixed_precision_arg_compute(
        state, num_labels, thresholds, ignore_index, min_recall, reduce_fn=_precision_at_recall
    )


def precision_at_fixed_recall(
    preds,
    target,
    task: str,
    min_recall: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor], Tuple[List[Tensor], List[Tensor]]]:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_at_fixed_recall(preds, target, min_recall, thresholds, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision_at_fixed_recall(
            preds, target, num_classes, min_recall, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision_at_fixed_recall(
            preds, target, num_labels, min_recall, thresholds, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
