"""Specificity-at-sensitivity functionals (counterpart of
``metrics_tpu/functional/classification/specificity_sensitivity.py``).

The fixed point is the first ROC point, in curve order (descending threshold), of
highest specificity among those whose sensitivity reaches ``min_sensitivity``;
``(0, 1e6)`` when none does. As for recall at precision, the selection is a masked
reduction on the device and exact mode keeps the fixed shape of the descending
sort (one sort and one segmented-scan launch per binary curve, class or label).
The exact ROC's first point, ``(fpr, tpr) = (0, 0)`` at threshold 1.0, qualifies
only for ``min_sensitivity <= 0``, and then it wins.
"""
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
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
)
from metrics_tpu_torch.functional.classification.recall_fixed_precision import _exact_binary, _first_where
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.ops.clf_curve import _ovr, _perlabel, binary_curve_counts
from metrics_tpu_torch.utils.compute import _smallest_f32_at_least
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _convert_fpr_to_specificity(fpr: Tensor) -> Tensor:
    return 1 - fpr


def _specificity_at_sensitivity(
    specificity: Tensor,
    sensitivity: Tensor,
    thresholds: Tensor,
    min_sensitivity: float,
    point: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Max specificity with sensitivity >= ``min_sensitivity`` along the last axis: the
    first such point in curve order (a NaN specificity counts as the largest, as for
    ``np.argmax``); ``(0, 1e6)`` when none qualifies. ``point`` masks the curve's rows."""
    thresholds = thresholds.expand(specificity.shape)
    ok = sensitivity >= float(_smallest_f32_at_least(min_sensitivity))
    if point is not None:
        ok = ok & point
    masked = torch.where(ok, specificity, float("-inf"))
    best = masked.amax(-1, keepdim=True)
    nan = ok & torch.isnan(specificity)
    pick = torch.where(nan.any(-1, keepdim=True), nan, ok & (masked == best))
    idx = _first_where(pick, False).unsqueeze(-1)
    any_ok = ok.any(-1)
    spec = torch.where(any_ok, torch.gather(specificity, -1, idx).squeeze(-1), 0.0).to(torch.float32)
    thr = torch.where(any_ok, torch.gather(thresholds, -1, idx).squeeze(-1), 1e6).to(torch.float32)
    return spec, thr


def _warn_missing_classes(pos: Tensor, neg: Tensor) -> None:
    """The exact ROC's warnings for a curve without negatives or positives, after one
    read of the per-curve totals."""
    for p, q in zip(pos.reshape(-1).tolist(), neg.reshape(-1).tolist()):
        if q <= 0:
            rank_zero_warn(
                "No negative samples in targets, false positive value should be meaningless."
                " Returning zero tensor in false positive score",
                UserWarning,
            )
        if p <= 0:
            rank_zero_warn(
                "No positive samples in targets, true positive value should be meaningless."
                " Returning zero tensor in true positive score",
                UserWarning,
            )


def _exact_specificity(min_sensitivity: float) -> Callable:
    """The fixed point of one binary exact ROC, as a column kernel of
    :func:`metrics_tpu_torch.ops.clf_curve._per_column`."""

    def kernel(preds: Tensor, target: Tensor, valid: Tensor, tier: str) -> Tuple[Tensor, Tensor]:
        if min_sensitivity <= 0:  # the ROC's first point (0, 0) at threshold 1.0 wins
            one = torch.ones((), dtype=torch.float32, device=preds.device)
            return one, one
        fps, tps, keys, point = binary_curve_counts(preds, target, valid, tier)
        pos, neg = tps[-1], fps[-1]
        fpr = torch.where(neg > 0, fps / neg, 0.0)
        tpr = torch.where(pos > 0, tps / pos, 0.0)
        return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), tpr, keys, min_sensitivity, point)

    return kernel


def _binary_specificity_at_sensitivity_arg_validation(
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if not isinstance(min_sensitivity, float) or not (0 <= min_sensitivity <= 1):
        raise ValueError(
            f"Expected argument `min_sensitivity` to be an float in the [0,1] range, but got {min_sensitivity}"
        )


def _binary_specificity_at_sensitivity_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    min_sensitivity: float,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor]:
    if _is_confmat_state(state):
        fpr, sensitivity, thresholds = _binary_roc_compute(state, thresholds, pos_label)
        return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)
    preds, target = state
    if pos_label != 1:
        target = torch.where(target >= 0, (target == pos_label).to(torch.int32), -1)
    _warn_missing_classes((target == 1).sum(), (target == 0).sum())
    return _exact_binary(_exact_specificity(min_sensitivity), preds, target)


def binary_specificity_at_sensitivity(
    preds,
    target,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity with sensitivity >= ``min_sensitivity``, and its threshold (binary)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_arg_validation(
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    if not isinstance(min_sensitivity, float) or not (0 <= min_sensitivity <= 1):
        raise ValueError(
            f"Expected argument `min_sensitivity` to be an float in the [0,1] range, but got {min_sensitivity}"
        )


def _multiclass_specificity_at_sensitivity_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    """Per class: binned ROCs all at once; exact ones one-vs-rest, one scan launch each."""
    if _is_confmat_state(state):
        fpr, sensitivity, thresholds = _multiclass_roc_compute(state, num_classes, thresholds)
        return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)
    preds, target = state
    pos = (target[:, None] == torch.arange(num_classes, device=target.device)).sum(0)
    _warn_missing_classes(pos, (target >= 0).sum() - pos)
    return _ovr(_exact_specificity(min_sensitivity), preds, target)


def multiclass_specificity_at_sensitivity(
    preds,
    target,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest specificity with sensitivity >= ``min_sensitivity`` (one-vs-rest)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_specificity_at_sensitivity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def _multilabel_specificity_at_sensitivity_arg_validation(
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    if not isinstance(min_sensitivity, float) or not (0 <= min_sensitivity <= 1):
        raise ValueError(
            f"Expected argument `min_sensitivity` to be an float in the [0,1] range, but got {min_sensitivity}"
        )


def _multilabel_specificity_at_sensitivity_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_sensitivity: float,
) -> Tuple[Tensor, Tensor]:
    """Per label: binned ROCs all at once; exact ones one scan launch each."""
    if _is_confmat_state(state):
        fpr, sensitivity, thresholds = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
        return _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)
    preds, target = state
    _warn_missing_classes((target == 1).sum(0), (target == 0).sum(0))
    return _perlabel(_exact_specificity(min_sensitivity), preds, target)


def multilabel_specificity_at_sensitivity(
    preds,
    target,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest specificity with sensitivity >= ``min_sensitivity``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index, min_sensitivity)


def specicity_at_sensitivity(
    preds,
    target,
    task: str,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor], Tuple[List[Tensor], List[Tensor]]]:
    """Task dispatcher; the public name keeps the JAX package's spelling (its alias
    ``specificity_at_sensitivity`` is the same function)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_specificity_at_sensitivity(
            preds, target, min_sensitivity, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_specificity_at_sensitivity(
            preds, target, num_classes, min_sensitivity, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_specificity_at_sensitivity(
            preds, target, num_labels, min_sensitivity, thresholds, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")


specificity_at_sensitivity = specicity_at_sensitivity
