"""Cohen's kappa functionals (counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``).

The confusion matrix comes from the ported confusion-matrix path: one histogram
kernel launch per call on the card.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """(C, C) confusion matrix -> kappa, in float32."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[:, None] - idx[None, :]
        w_mat = torch.abs(diff) if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def _check_weights(weights: Optional[str]) -> None:
    if weights not in ("linear", "quadratic", "none", None):
        raise ValueError(
            f"Expected argument `weight` to be one of ('linear', 'quadratic', 'none', None), but got {weights}."
        )


def _binary_cohen_kappa_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
    _check_weights(weights)


def _multiclass_cohen_kappa_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, weights: Optional[str] = None
) -> None:
    _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
    _check_weights(weights)


def binary_cohen_kappa(
    preds, target, threshold: float = 0.5, weights: Optional[str] = None, ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_cohen_kappa_arg_validation(threshold, ignore_index, weights)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _cohen_kappa_reduce(_binary_confusion_matrix_update(preds, target), weights)


def multiclass_cohen_kappa(
    preds, target, num_classes: int, weights: Optional[str] = None, ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_cohen_kappa_arg_validation(num_classes, ignore_index, weights)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _cohen_kappa_reduce(_multiclass_confusion_matrix_update(preds, target, num_classes), weights)


def cohen_kappa(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    weights: Optional[str] = None, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher (binary or multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args, device)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
