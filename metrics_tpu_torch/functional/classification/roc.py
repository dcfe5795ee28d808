"""ROC curve functionals (counterpart of ``metrics_tpu/functional/classification/roc.py``).

They share the precision-recall curve's state: a binned ``(T, ..., 2, 2)`` confusion
tensor, or the raw scores in exact mode.
"""
from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _is_confmat_state,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _one_vs_rest,
    _traced_per_column,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _binary_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(fpr, tpr, thresholds)``, thresholds descending; a missing class zeroes its rate."""
    if _is_confmat_state(state) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0)
        fpr = _safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)

    if not _is_concrete(state[0], state[1]):
        # under a trace: the static-shape device ROC; the first K rows are the eager
        # curve, the pads carry NaN thresholds
        from metrics_tpu_torch.ops.clf_curve import binary_roc_curve_padded

        target = state[1] if pos_label == 1 else _one_vs_rest(state[1], pos_label)
        fpr, tpr, thresholds, _ = binary_roc_curve_padded(state[0], target)
        return fpr, tpr, thresholds

    preds, target = state
    keep = target >= 0
    fps, tps, thresholds = _binary_clf_curve(preds[keep], target[keep], pos_label=pos_label)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([torch.ones(1, dtype=thresholds.dtype, device=thresholds.device), thresholds])

    if float(fps[-1]) <= 0:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros_like(thresholds)
    else:
        fpr = fps / fps[-1]

    if float(tps[-1]) <= 0:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros_like(thresholds)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def binary_roc(
    preds,
    target,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary ROC: ``(fpr, tpr, thresholds)``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if _is_confmat_state(state) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).t()
        fpr = _safe_divide(fps, fps + tns).flip(0).t()
        return fpr, tpr, thresholds.flip(0)
    if not _is_concrete(state[0], state[1]):
        from metrics_tpu_torch.ops.clf_curve import binary_roc_curve_padded

        return _traced_per_column(binary_roc_curve_padded, state[0], state[1], multiclass=True)

    fpr, tpr, thresholds_out = [], [], []
    for i in range(num_classes):
        res = _binary_roc_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds_out.append(res[2])
    return fpr, tpr, thresholds_out


def multiclass_roc(
    preds,
    target,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Multiclass ROC, one-vs-rest per class."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_roc_compute(state, num_classes, thresholds)


def _multilabel_roc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if _is_confmat_state(state) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).t()
        fpr = _safe_divide(fps, fps + tns).flip(0).t()
        return fpr, tpr, thresholds.flip(0)
    if not _is_concrete(state[0], state[1]):
        from metrics_tpu_torch.ops.clf_curve import binary_roc_curve_padded

        return _traced_per_column(binary_roc_curve_padded, state[0], state[1], multiclass=False)

    fpr, tpr, thresholds_out = [], [], []
    for i in range(num_labels):
        preds_i, target_i = state[0][:, i], state[1][:, i]
        if ignore_index is not None:
            keep = target_i >= 0
            preds_i, target_i = preds_i[keep], target_i[keep]
        res = _binary_roc_compute((preds_i, target_i), thresholds=None, pos_label=1)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds_out.append(res[2])
    return fpr, tpr, thresholds_out


def multilabel_roc(
    preds,
    target,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Multilabel ROC, one per label."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds,
    target,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
):
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
