"""Matthews correlation coefficient functionals (counterpart of
``metrics_tpu/functional/classification/matthews_corrcoef.py``).

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
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.utils.enums import ClassificationTask


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """Confusion matrix -> MCC in float32; 0/0 -> 0. Multilabel (L, 2, 2) sums to one 2 x 2."""
    confmat = confmat.sum(0) if confmat.ndim == 3 else confmat
    tk = confmat.sum(dim=-1).to(torch.float32)
    pk = confmat.sum(dim=-2).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = confmat.sum().to(torch.float32)

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)

    denom = cov_ypyp * cov_ytyt
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / torch.sqrt(torch.where(zero, 1.0, denom)))


def binary_matthews_corrcoef(
    preds, target, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target))


def multiclass_matthews_corrcoef(
    preds, target, num_classes: int, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, num_classes))


def multilabel_matthews_corrcoef(
    preds, target, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, num_labels))


def matthews_corrcoef(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
