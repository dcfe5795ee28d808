"""Hinge loss functionals (counterpart of ``metrics_tpu/functional/classification/hinge.py``).

Plain torch ops, no kernel: margins clipped at 0 (squared or not), summed with the
samples at ``ignore_index`` weighted 0, over the count of the others. Multiclass
takes Crammer-Singer margins (the true class's score minus the best other one)
or one-vs-all margins per class.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs, _softmax_if_logits
from metrics_tpu_torch.utils.data import _one_hot
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    return measure / total


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _masked_sums(measures: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum of ``measures`` over the valid samples (axis 0), and their count."""
    mask = valid if measures.ndim == 1 else valid[:, None]
    return torch.where(mask, measures, 0.0).sum(dim=0), valid.sum()


def _binary_hinge_loss_update(preds: Tensor, target: Tensor, squared: bool) -> Tuple[Tensor, Tensor]:
    """Margin sum and sample count; targets < 0 (``ignore_index``) weigh 0."""
    margin = torch.where(target == 1, preds, -preds)
    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures.square()
    return _masked_sums(measures, target >= 0)


def binary_hinge_loss(
    preds,
    target,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
    device=None,
) -> Tensor:
    """Mean hinge loss for binary tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.0, ignore_index=ignore_index, convert_to_labels=False
    )
    return _hinge_loss_compute(*_binary_hinge_loss_update(preds, target, squared))


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    allowed_mm = ("crammer-singer", "one-vs-all")
    if multiclass_mode not in allowed_mm:
        raise ValueError(f"Expected argument `multiclass_mode` to be one of {allowed_mm}, but got {multiclass_mode}.")


def _multiclass_hinge_loss_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    squared: bool,
    multiclass_mode: str = "crammer-singer",
) -> Tuple[Tensor, Tensor]:
    """Margin sums (a scalar, or one per class for one-vs-all) and the sample count."""
    preds = _softmax_if_logits(preds)
    target_onehot = _one_hot(torch.clamp(target, min=0), max(2, preds.shape[1])).to(torch.bool)
    if multiclass_mode == "crammer-singer":
        margin = torch.where(target_onehot, preds, 0.0).sum(dim=1)
        margin = margin - torch.where(target_onehot, float("-inf"), preds).amax(dim=1)
    else:
        margin = (2 * target_onehot.to(preds.dtype) - 1) * preds
    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures.square()
    return _masked_sums(measures, target >= 0)


def multiclass_hinge_loss(
    preds,
    target,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
    device=None,
) -> Tensor:
    """Mean hinge loss for multiclass tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    return _hinge_loss_compute(*_multiclass_hinge_loss_update(preds, target, squared, multiclass_mode))


def hinge_loss(
    preds,
    target,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args, device)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_hinge_loss(
            preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
