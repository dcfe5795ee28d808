"""Calibration error functionals (counterpart of
``metrics_tpu/functional/classification/calibration_error.py``).

Confidences fall into ``n_bins + 1`` bins, ``searchsorted(side="right") - 1`` over
the boundaries of ``jnp.linspace(0, 1, n_bins + 1, dtype=float32)``, bit for bit
(``torch.linspace`` rounds some of them differently): the last bin holds only the
confidences of exactly 1.0, as in the JAX package. The three per-bin sums go
through the histogram kernel on the card: the sample count (count mode) and the
correct count (mask mode, accuracies being 0 or 1) in int32, exact past 2^24 per
bin where the JAX package's float32 sums are not, and the confidence sum in float32
(weight mode). Masked samples drop through a bin id of -1.
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs, _softmax_if_logits
from metrics_tpu_torch.utils.data import _bincount, _bincount_weighted
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _bin_boundaries(n_bins: int, device) -> Tensor:
    """The ``n_bins + 1`` float32 boundaries of ``jnp.linspace(0, 1, n_bins + 1)``."""
    return _adjust_threshold_arg(n_bins + 1, device)


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor, valid: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin accuracy, confidence and proportion of the samples, over ``len(bin_boundaries)`` bins."""
    n_bins = bin_boundaries.shape[0]
    confidences = confidences.to(torch.float32).reshape(-1)
    ids = torch.searchsorted(bin_boundaries, confidences, right=True) - 1
    ids = ids.clamp(0, n_bins - 1).to(torch.int32)
    if valid is not None:
        ids = torch.where(valid.reshape(-1), ids, -1)
    count = _bincount(ids, n_bins)
    correct = _bincount_weighted(ids, accuracies.reshape(-1) != 0, n_bins)
    conf_sum = _bincount_weighted(ids, confidences.contiguous(), n_bins)
    count_f = count.to(torch.float32)
    conf_bin = torch.nan_to_num(conf_sum / count_f)
    acc_bin = torch.nan_to_num(correct.to(torch.float32) / count_f)
    prop_bin = count_f / count.sum().to(torch.float32)
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Union[Tensor, int],
    norm: str = "l1",
    debias: bool = False,
    valid: Optional[Tensor] = None,
) -> Tensor:
    """Calibration error of the binned samples under ``norm`` (l1, l2 or max)."""
    if isinstance(bin_boundaries, int):
        bin_boundaries = _bin_boundaries(bin_boundaries, confidences.device)
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries, valid)
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum(torch.square(acc_bin - conf_bin) * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), 0.0)


def _binary_calibration_error_arg_validation(
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    allowed_norm = ("l1", "l2", "max")
    if norm not in allowed_norm:
        raise ValueError(f"Expected argument `norm` to be one of {allowed_norm}, but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _binary_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    return preds, target


def binary_calibration_error(
    preds,
    target,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Top-label calibration error for binary tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.0, ignore_index=ignore_index, convert_to_labels=False
    )
    valid = target >= 0 if ignore_index is not None else None
    confidences, accuracies = _binary_calibration_error_update(preds, torch.clamp(target, min=0))
    return _ce_compute(confidences, accuracies, n_bins, norm, valid=valid)


def _multiclass_calibration_error_arg_validation(
    num_classes: int,
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _multiclass_calibration_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-1 confidence and correctness of each ``(N, C)`` row (softmax first iff logits)."""
    preds = _softmax_if_logits(preds)
    confidences, predictions = preds.max(dim=1)
    accuracies = (predictions == target).to(torch.float32)
    return confidences.to(torch.float32), accuracies


def multiclass_calibration_error(
    preds,
    target,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Top-label calibration error for multiclass tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    valid = target >= 0 if ignore_index is not None else None
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm, valid=valid)


def calibration_error(
    preds,
    target,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args, device)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
