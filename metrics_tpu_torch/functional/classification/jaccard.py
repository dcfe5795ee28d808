"""Jaccard index (IoU) functionals (counterpart of ``metrics_tpu/functional/classification/jaccard.py``)."""
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
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import ClassificationTask


def _jaccard_index_reduce(
    confmat: Tensor,
    average: Optional[str],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Confusion matrix -> Jaccard score.

    As in the JAX package, an ``ignore_index`` in ``[0, C]`` takes its class out of the
    micro denominator and the macro weights; ``ignore_index == C`` reads class C-1 in
    the micro denominator (JAX clamps the gather) and sets no macro weight (JAX drops
    the out-of-bounds scatter).
    """
    allowed_average = ["binary", "micro", "macro", "weighted", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return confmat[1, 1] / (confmat[0, 1] + confmat[1, 0] + confmat[1, 1])

    ignore_index_cond = ignore_index is not None and 0 <= ignore_index <= confmat.shape[0]
    if confmat.ndim == 3:  # multilabel
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:  # multiclass
        num = torch.diag(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num

    if average == "micro":
        num = num.sum()
        skipped = denom[min(ignore_index, denom.shape[0] - 1)] if ignore_index_cond else 0.0
        denom = denom.sum() - skipped

    jaccard = _safe_divide(num, denom)

    if average is None or average == "none" or average == "micro":
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if confmat.ndim == 3 else confmat.sum(1)
    else:
        weights = torch.ones_like(jaccard)
        if ignore_index_cond and ignore_index < weights.shape[0]:
            weights[ignore_index] = 0.0
    return ((weights * jaccard) / weights.sum()).sum()


def binary_jaccard_index(
    preds, target, threshold: float = 0.5, ignore_index: Optional[int] = None, validate_args: bool = True, device=None
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _jaccard_index_reduce(_binary_confusion_matrix_update(preds, target), average="binary")


def multiclass_jaccard_index(
    preds, target, num_classes: int, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(
    preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def jaccard_index(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
