"""Recall-at-fixed-precision functionals (counterpart of
``metrics_tpu/functional/classification/recall_fixed_precision.py``).

The fixed point is the lexicographic max of (recall, precision, threshold) over the
curve points whose precision reaches ``min_precision``. The JAX package picks it on
the host, one Python tuple per curve point, when it runs eagerly; here it is the
masked-max cascade of its traced branch, on the device, so that a compute reads
nothing back. In exact mode (``thresholds=None``) the curve stays in the fixed
shape of the descending sort (:func:`metrics_tpu_torch.ops.clf_curve.binary_curve_counts`:
one sort and one segmented-scan launch per binary curve, and per class or label
through the one-vs-rest and per-label column loops of that module), its points
marked by a mask; binned mode reduces the ``(..., T)`` curve of the
confusion tensor, every class at once.
"""
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _is_confmat_state,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.ops.clf_curve import _ovr, _pad_binary, _perlabel, binary_curve_counts
from metrics_tpu_torch.ops.rank import select_tier
from metrics_tpu_torch.utils.compute import _smallest_f32_at_least
from metrics_tpu_torch.utils.enums import ClassificationTask


def _first_where(mask: Tensor, descending: bool) -> Tensor:
    """Index along the last axis of the first True of ``mask`` in curve order (the
    last True when the rows run in ``descending`` score order); 0 when there is none."""
    n = mask.shape[-1]
    rows = torch.arange(n, device=mask.device)
    if descending:
        return torch.where(mask, rows, -1).amax(-1).clamp_min(0)
    return torch.where(mask, rows, n).amin(-1).clamp_max(n - 1)


def _lexicographic_best(
    primary: Tensor,
    secondary: Tensor,
    thresholds: Tensor,
    min_secondary: float,
    point: Optional[Tensor] = None,
    descending: bool = False,
) -> Tuple[Tensor, Tensor]:
    """max of the (primary, secondary, threshold) triples whose secondary >= ``min_secondary``,
    along the last axis; ``(0, 1e6)`` when none qualifies.

    A cascade of masked maxes: the best primary, then the best secondary among its
    ties, then the best threshold among those. It decides as the JAX package's
    eager ``max`` over float64 tuples: the values lie on the float32 grid, so the
    float32 compare against the smallest float32 >= ``min_secondary`` decides as
    the float64 one; a NaN primary in the first qualifying triple (in curve order)
    wins, as it does for Python's ``max``, and any other NaN primary loses. The
    threshold is pinned to 1e6 whenever the best primary is 0.

    ``point`` masks the rows that are curve points, and ``descending`` says the
    rows run in descending score order (the reverse of the curve's order), as in
    exact mode. ``thresholds`` may be one shared row for a batch of curves.
    """
    n = min(primary.shape[-1], secondary.shape[-1], thresholds.shape[-1])
    p, s = primary[..., :n], secondary[..., :n]
    t = thresholds[..., :n].expand(p.shape)
    ok = s >= float(_smallest_f32_at_least(min_secondary))
    if point is not None:
        ok = ok & point
    neg = torch.full((), float("-inf"), dtype=p.dtype, device=p.device)
    numeric = ok & ~torch.isnan(p)
    best_p = torch.where(numeric, p, neg).amax(-1, keepdim=True)
    tie_p = numeric & (p == best_p)
    best_s = torch.where(tie_p, s, neg).amax(-1, keepdim=True)
    best_t = torch.where(tie_p & (s == best_s), t, neg).amax(-1)
    best_p = best_p.squeeze(-1)
    first = _first_where(ok, descending).unsqueeze(-1)
    first_p = torch.gather(p, -1, first).squeeze(-1)
    first_nan = torch.isnan(first_p)
    best_p = torch.where(first_nan, first_p, best_p)
    best_t = torch.where(first_nan, torch.gather(t, -1, first).squeeze(-1), best_t)
    any_ok = ok.any(-1)
    best_primary = torch.where(any_ok, best_p, 0.0).to(torch.float32)
    best_threshold = torch.where(any_ok, best_t, 0.0).to(torch.float32)
    best_threshold = torch.where(best_primary == 0.0, 1e6, best_threshold).to(torch.float32)
    return best_primary, best_threshold


def _recall_at_precision(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_precision: float,
    point: Optional[Tensor] = None,
    descending: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Max recall (then precision, then threshold) with precision >= ``min_precision``."""
    return _lexicographic_best(recall, precision, thresholds, min_precision, point, descending)


def _exact_reduce(reduce_fn: Callable, min_value: float) -> Callable:
    """``reduce_fn`` on one binary exact curve, as a column kernel of
    :func:`metrics_tpu_torch.ops.clf_curve._per_column`: ``(preds, target, valid, tier)``
    to the fixed point and its threshold."""

    def kernel(preds: Tensor, target: Tensor, valid: Tensor, tier: str) -> Tuple[Tensor, Tensor]:
        fps, tps, keys, point = binary_curve_counts(preds, target, valid, tier)
        return reduce_fn(tps / (tps + fps), tps / tps[-1], keys, min_value, point=point, descending=True)

    return kernel


def _exact_binary(kernel: Callable, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target, valid = _pad_binary(preds, target)
    return kernel(preds, target, valid, select_tier(preds))


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
        raise ValueError(
            f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
        )


def _binary_recall_at_fixed_precision_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    min_precision: float,
    pos_label: int = 1,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    if _is_confmat_state(state):
        precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
        return reduce_fn(precision, recall, thresholds, min_precision)
    preds, target = state
    if pos_label != 1:
        target = torch.where(target >= 0, (target == pos_label).to(torch.int32), -1)
    return _exact_binary(_exact_reduce(reduce_fn, min_precision), preds, target)


def binary_recall_at_fixed_precision(
    preds,
    target,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Highest recall with precision >= ``min_precision``, and its threshold (binary)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
        raise ValueError(
            f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
        )


def _multiclass_recall_at_fixed_precision_arg_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
    min_precision: float,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    """Per class: binned curves all at once; exact ones one-vs-rest, one scan launch each."""
    if _is_confmat_state(state):
        precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
        return reduce_fn(precision, recall, thresholds, min_precision)
    return _ovr(_exact_reduce(reduce_fn, min_precision), *state)


def multiclass_recall_at_fixed_precision(
    preds,
    target,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest recall with precision >= ``min_precision`` (one-vs-rest)."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_recall_at_fixed_precision_arg_compute(state, num_classes, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    if not isinstance(min_precision, float) or not (0 <= min_precision <= 1):
        raise ValueError(
            f"Expected argument `min_precision` to be an float in the [0,1] range, but got {min_precision}"
        )


def _multilabel_recall_at_fixed_precision_arg_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int],
    min_precision: float,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[Tensor, Tensor]:
    """Per label: binned curves all at once; exact ones one scan launch each."""
    if _is_confmat_state(state):
        precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
            state, num_labels, thresholds, ignore_index
        )
        return reduce_fn(precision, recall, thresholds, min_precision)
    return _perlabel(_exact_reduce(reduce_fn, min_precision), *state)


def multilabel_recall_at_fixed_precision(
    preds,
    target,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest recall with precision >= ``min_precision``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_recall_at_fixed_precision_arg_compute(state, num_labels, thresholds, ignore_index, min_precision)


def recall_at_fixed_precision(
    preds,
    target,
    task: str,
    min_precision: float,
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
        return binary_recall_at_fixed_precision(
            preds, target, min_precision, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_recall_at_fixed_precision(
            preds, target, num_classes, min_precision, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_recall_at_fixed_precision(
            preds, target, num_labels, min_precision, thresholds, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
