"""Confusion matrices (counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``).

``ignore_index`` maps positions to target ``-1`` and the update drops them through a
masked histogram (no boolean indexing); an out-of-range ``ignore_index`` such as 255
thus becomes ``-1``, is clipped into range and carries no weight.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _as_inputs,
    _check_binary_values,
    _check_multiclass_values,
    _sigmoid_if_logits,
)
from metrics_tpu_torch.ops.confmat import confusion_counts
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _bincount_weighted
from metrics_tpu_torch.utils.enums import ClassificationTask

_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize a confusion matrix; rows or columns that sum to 0 give 0."""
    if normalize not in _NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=-1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=-2, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
        confmat = torch.nan_to_num(confmat, nan=0.0)
    return confmat


def _masked_confmat_bins(mapping: Tensor, valid: Tensor, length: int) -> Tensor:
    """int64 histogram of ``mapping`` where ``valid``; ignored entries carry no weight."""
    mapping = mapping.clamp(0, length - 1).to(torch.int32)
    return _bincount_weighted(mapping, valid.to(torch.bool), length).to(torch.int64)


def _check_normalize(normalize: Optional[str]) -> None:
    if normalize not in _NORMALIZE:
        raise ValueError(
            f"Expected argument `normalize` to be one of ('true', 'pred', 'all', 'none', None), but got {normalize}."
        )


def _check_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


# ----------------------------------------------------------------------- binary


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _binary_confusion_matrix_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    _check_binary_values(preds, target, ignore_index, "preds")


def _binary_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Flatten + sigmoid/threshold; ignored targets -> -1."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    if preds.is_floating_point():
        preds = _sigmoid_if_logits(preds)
        if convert_to_labels:
            preds = (preds > threshold).to(torch.int32)
    return preds, target


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor) -> Tensor:
    return _masked_confmat_bins(target * 2 + preds, target >= 0, 4).reshape(2, 2)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds,
    target,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """2x2 confusion matrix for binary tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _binary_confusion_matrix_compute(_binary_confusion_matrix_update(preds, target), normalize)


# -------------------------------------------------------------------- multiclass


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    _check_multiclass_values(preds, target, num_classes, ignore_index)


def _multiclass_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Argmax + flatten; ignored targets -> -1."""
    if preds.ndim == target.ndim + 1 and convert_to_labels:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(-1) if convert_to_labels else torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_confusion_matrix_update(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """C x C int64 counts through one histogram launch."""
    return confusion_counts(preds, target, target >= 0, num_classes)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds,
    target,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """C x C confusion matrix for multiclass tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _multiclass_confusion_matrix_compute(_multiclass_confusion_matrix_update(preds, target, num_classes), normalize)


# -------------------------------------------------------------------- multilabel


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _check_ignore_index(ignore_index)
    _check_normalize(normalize)


def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    _check_binary_values(preds, target, ignore_index, "preds")


def _multilabel_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    should_threshold: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Sigmoid/threshold + reshape to (-1, L); ignored targets -> -1."""
    if preds.is_floating_point():
        preds = _sigmoid_if_logits(preds)
        if should_threshold:
            preds = (preds > threshold).to(torch.int32)
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, num_labels: int) -> Tensor:
    mapping = 2 * target + preds + 4 * torch.arange(num_labels, device=preds.device)
    return _masked_confmat_bins(mapping, target >= 0, 4 * num_labels).reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """(L, 2, 2) confusion matrices for multilabel tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_confusion_matrix_compute(_multilabel_confusion_matrix_update(preds, target, num_labels), normalize)


def confusion_matrix(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_confusion_matrix(
            preds, target, num_labels, threshold, normalize, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
