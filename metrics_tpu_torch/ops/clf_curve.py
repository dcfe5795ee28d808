"""Exact-mode (``thresholds=None``) AUROC and average precision on the device.

Counterpart of ``metrics_tpu/ops/clf_curve.py``. The scalar summaries of the curve
never need its data-dependent length:

- sort descending by score (the f32 sort tier here, or the rank tier of
  :mod:`metrics_tpu_torch.ops.rank`, which gives bit-identical counts);
- cumulative positives at every position (``cumsum``);
- tie runs collapsed by giving every row its run-end counts: ONE reverse fused
  multi-scan (:func:`metrics_tpu_torch.ops.segment.segment_multi_scan`, the
  hand-written CUDA kernel on the card) propagates both run-end streams (positives
  and run position) as two ``min`` lanes over one global segment.

Rows with ``valid`` False (ignore_index masks) take the -inf key and form a
terminal run that adds only duplicated end points.

The sort tier canonicalizes the zero-exponent class (±0.0 and every denormal) to
+0.0 in integer space before it sorts: the JAX package's XLA sort and compare flush
denormals, so its oracle treats that class as one tie run, and PyTorch does not
flush. The eager curve-shaped functions (``_binary_clf_curve``) do not do this, as
the JAX package runs them with numpy on the host.

The JAX package pads each input to a power of two (``_pad_binary``, ``_pad_rows``)
only to bound its recompiles; padded rows are invalid and change no result, so the
port does not pad the scalar summaries. One-vs-rest and per-label variants run the
binary kernel once per column.

The static-shape curves (:func:`binary_precision_recall_curve_padded`,
:func:`binary_roc_curve_padded`, JAX ``ops/clf_curve.py:254-365``) serve the curve
computes under a trace (a capture, ``torch.func.vmap``, the engines' steps), where
the eager curves' data-dependent length cannot be: the same sort and scan, the
curve's points front-packed into arrays of the padded input's length. They keep the
JAX package's power-of-two padding, so their shapes are its shapes. The whole
post-sort tail reads nothing on the host and runs under ``vmap``, where a stack of
curves is one batched sort and one scan launch.

``tolerance > 0`` on the scalar entry points (:func:`_sketch_dispatch`, JAX
``ops/clf_curve.py:205-250``) probes the bucket-histogram bracket of
:mod:`metrics_tpu_torch.ops.rank` (two mask-mode histogram launches, no sort) and
serves its midpoint when its width fits the tolerance (a host read, as in the JAX
package), falling back to the exact tier otherwise; inside a trace (a ``torch.func``
transform, a CUDA-graph capture, an engine's step) the width cannot be read and the
exact tier serves. The JAX package's serve-side executable cache (``_warm_record``)
has no counterpart in the port yet. Each entry point counts its tier with
``ops/rank.py:record_dispatch`` and runs inside ``rank_scope``.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import rank as _rank
from metrics_tpu_torch.ops.segment import segment_multi_scan
from metrics_tpu_torch.utils.checks import _is_concrete

_INT32_MAX = (1 << 31) - 1


def _run_end_lanes(sorted_keys: Tensor, is_pos: Tensor) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
    """The two int32 scan lanes of the run-end propagation, and the run-end mask.

    ``boundary`` marks the last row of each tie run of the sorted keys. Lane 0 holds
    the cumulative positive count at run ends (``INT32_MAX`` elsewhere), lane 1 the
    row position at run ends (``n - 1`` elsewhere): a reverse running ``min`` of each
    gives every row the value at the end of its run.
    """
    n = sorted_keys.shape[0]
    tps_all = torch.cumsum(is_pos, 0, dtype=torch.int32)
    # a concatenation, not a write into a fresh tensor: it runs under torch.func.vmap
    last = torch.ones(1, dtype=torch.bool, device=sorted_keys.device)
    boundary = torch.cat([sorted_keys[1:] != sorted_keys[:-1], last])
    pos = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    return (torch.where(boundary, tps_all, _INT32_MAX), torch.where(boundary, pos, n - 1)), boundary


def _fps_tps_from_scan(tps: Tensor, run_end: Tensor, n_valid: Tensor) -> Tuple[Tensor, Tensor]:
    """(fps, tps) from the scanned lanes: valid rows sort first, so the valid count up
    to ``run_end`` is ``min(run_end + 1, n_valid)``."""
    return torch.minimum(run_end + 1, n_valid) - tps, tps


def _fps_tps_from_sorted(sorted_keys: Tensor, is_pos: Tensor, n_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(fps, tps, boundary) of the descending-sorted keys: the shared post-sort tail."""
    lanes, boundary = _run_end_lanes(sorted_keys, is_pos)
    tps, run_end = segment_multi_scan(lanes, None, ops=("min", "min"), reverse=True)
    fps, tps = _fps_tps_from_scan(tps, run_end, n_valid)
    return fps, tps, boundary


def _canonical_zero(key: Tensor) -> Tensor:
    """f32 keys with the zero-exponent class (±0.0, ±denormals) mapped to +0.0,
    tested on the raw bits so that no float compare can flush or split it."""
    bits = _rank.f32_bits(key)
    return torch.where((bits & _rank._EXP_FIELD) == 0, torch.zeros((), dtype=key.dtype, device=key.device), key)


def _run_end_counts(
    preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(fps, tps) at every position of the descending-score sort, tie runs collapsed.

    Returns int32 ``fps``/``tps`` of shape (N,) plus the descending sort keys and the
    tie-run-end mask. ``tps[-1]``/``fps[-1]`` are the valid positive/negative totals.
    ``tier="rank"`` takes :func:`metrics_tpu_torch.ops.rank.rank_run_end_counts`.
    """
    if tier == "rank":
        return _rank.rank_run_end_counts(preds, target, valid)
    key = torch.where(valid, preds.to(torch.float32), float("-inf"))
    sk, order = torch.sort(_canonical_zero(key), descending=True)
    st = torch.where(valid, target.to(torch.int32), -1)[order]
    fps, tps, boundary = _fps_tps_from_sorted(sk, st == 1, (st >= 0).sum(dtype=torch.int32))
    return fps, tps, sk, boundary


def _roc_points(
    preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(fpr0, tpr0) with a prepended origin, plus the positive and negative totals."""
    fps, tps, _, _ = _run_end_counts(preds, target, valid, tier)
    pos, neg = tps[-1], fps[-1]
    tpr = tps.to(torch.float32) / torch.clamp(pos, min=1)
    fpr = fps.to(torch.float32) / torch.clamp(neg, min=1)
    zero = torch.zeros(1, dtype=torch.float32, device=fps.device)
    return torch.cat([zero, fpr]), torch.cat([zero, tpr]), pos, neg


def _trapz(y: Tensor, x: Tensor) -> Tensor:
    return torch.sum(torch.diff(x) * (y[1:] + y[:-1]) * 0.5)


def mcclish_partial_auc(fpr: Tensor, tpr: Tensor, max_fpr: Tensor) -> Tensor:
    """McClish-standardized partial AUC of an ascending-``fpr`` ROC curve.

    Clips the curve at ``fpr == max_fpr``, interpolating ``tpr`` on the crossing
    segment (points past the clip collapse to zero-width segments), then applies the
    McClish correction. ``max_fpr`` is a float32 scalar tensor.
    """
    m = fpr.shape[0] - 1
    stop = torch.searchsorted(fpr.contiguous(), max_fpr.reshape(1), right=True)[0]
    lo = torch.clamp(stop - 1, 0, m)
    hi = torch.clamp(stop, 0, m)
    denom = fpr[hi] - fpr[lo]
    w = torch.where(denom > 0, (max_fpr - fpr[lo]) / torch.where(denom > 0, denom, 1.0), 0.0)
    interp = tpr[lo] + w * (tpr[hi] - tpr[lo])
    xc = torch.minimum(fpr, max_fpr)
    yc = torch.where(fpr > max_fpr, interp, tpr)
    partial_auc = _trapz(yc, xc)
    min_area = 0.5 * max_fpr**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_fpr - min_area))


def _binary_auroc_kernel(
    preds: Tensor, target: Tensor, valid: Tensor, max_fpr: Optional[Tensor], tier: str = "sort"
) -> Tensor:
    """Exact binary AUROC; 0.0 when a class is absent (NaN for a partial AUC)."""
    fpr0, tpr0, pos, neg = _roc_points(preds, target, valid, tier)
    if max_fpr is None:
        return _trapz(tpr0, fpr0)
    area = mcclish_partial_auc(fpr0, tpr0, max_fpr)
    return torch.where((pos > 0) & (neg > 0), area, float("nan"))


def _binary_ap_kernel(preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort") -> Tuple[Tensor, Tensor]:
    """Exact binary average precision and the positive count; NaN when no positives."""
    fps, tps, _, _ = _run_end_counts(preds, target, valid, tier)
    pos = tps[-1]
    tot = (tps + fps).to(torch.float32)
    precision = torch.where(tot > 0, tps.to(torch.float32) / torch.where(tot > 0, tot, 1.0), 0.0)
    recall = tps.to(torch.float32) / torch.clamp(pos, min=1)
    ap = torch.sum(torch.diff(recall, prepend=torch.zeros(1, device=recall.device)) * precision)
    return torch.where(pos > 0, ap, float("nan")), pos


def _pad_binary(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Flattened preds, int32 targets and the valid mask (no padding: see the module note)."""
    target = target.reshape(-1).to(torch.int32)  # signed: -1 marks ignored rows
    return preds.reshape(-1), target, target >= 0


def _next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _pad_pow2(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """:func:`_pad_binary` padded to the next power of two with invalid rows (target
    -1), as the JAX package pads: the padded curves' length is its length."""
    preds, target, _ = _pad_binary(preds, target)
    pad = _next_pow2(preds.shape[0]) - preds.shape[0]
    if pad:
        preds = torch.cat([preds, preds.new_zeros(pad)])
        target = torch.cat([target, target.new_full((pad,), -1)])
    return preds, target, target >= 0


def _binary_curve_padded_kernel(
    preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Static-shape exact PR curve: precision ``(N+1,)``, recall ``(N+1,)``, thresholds
    ``(N,)`` and the point count K.

    The first K entries are the eager curve (ascending thresholds); precision and
    recall pads repeat the final point (1, 0), zero-width segments under integration,
    and threshold pads are NaN. No positives give NaN recall, as the eager curve does.
    """
    n = preds.shape[0]
    fps, tps, sk, run_boundary = _run_end_counts(preds, target, valid, tier)
    boundary = run_boundary & (sk != float("-inf"))  # the invalid rows' terminal run is no point
    pos = tps[-1]
    precision_all = tps.to(torch.float32) / torch.clamp(tps + fps, min=1)
    recall_all = torch.where(pos > 0, tps.to(torch.float32) / torch.clamp(pos, min=1), float("nan"))
    # ascending thresholds: flip, then front-pack the run ends
    prec, rec, thr = _rank.stable_front_pack(boundary.flip(0), precision_all.flip(0), recall_all.flip(0), sk.flip(0))
    k = boundary.sum(dtype=torch.int32)
    head = torch.arange(n, device=preds.device) < k
    one = torch.ones(1, dtype=torch.float32, device=preds.device)
    precision = torch.cat([torch.where(head, prec, 1.0), one])
    recall = torch.cat([torch.where(head, rec, 0.0), torch.zeros_like(one)])
    return precision, recall, torch.where(head, thr, float("nan")), k


def binary_precision_recall_curve_padded(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Exact (``thresholds=None``) PR curve on the device with static shapes:
    ``(precision, recall, thresholds, K)``, ``target`` entries < 0 excluded (see
    :func:`_binary_curve_padded_kernel` for the padding contract). One sort and one
    scan launch; a stack under ``torch.func.vmap`` is one of each."""
    preds, target, valid = _pad_pow2(preds, target)
    return _binary_curve_padded_kernel(preds, target, valid, _rank.select_tier(preds))


def _binary_roc_padded_kernel(
    preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Static-shape exact ROC: fpr, tpr and thresholds ``(N+1,)`` and K.

    The eager layout: descending thresholds after a prepended (0, 0, 1.0) origin;
    the first K entries are exact, pads repeat the terminal point with NaN
    thresholds, and single-class data zeroes the missing rate, as eagerly.
    """
    n = preds.shape[0]
    fps, tps, sk, run_boundary = _run_end_counts(preds, target, valid, tier)
    boundary = run_boundary & (sk != float("-inf"))
    pos, neg = tps[-1], fps[-1]
    tpr_all = torch.where(pos > 0, tps.to(torch.float32) / torch.clamp(pos, min=1), 0.0)
    fpr_all = torch.where(neg > 0, fps.to(torch.float32) / torch.clamp(neg, min=1), 0.0)
    tprp, fprp, thrp = _rank.stable_front_pack(boundary, tpr_all, fpr_all, sk)
    k = boundary.sum(dtype=torch.int32)
    head = torch.arange(n, device=preds.device) < k
    zero = torch.zeros(1, dtype=torch.float32, device=preds.device)
    fpr = torch.cat([zero, torch.where(head, fprp, (neg > 0).to(torch.float32))])
    tpr = torch.cat([zero, torch.where(head, tprp, (pos > 0).to(torch.float32))])
    thresholds = torch.cat([torch.ones_like(zero), torch.where(head, thrp, float("nan"))])
    return fpr, tpr, thresholds, k + 1


def binary_roc_curve_padded(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Exact ROC on the device with static shapes: ``(fpr, tpr, thresholds, K)``,
    ``target`` entries < 0 excluded; the sibling of
    :func:`binary_precision_recall_curve_padded`."""
    preds, target, valid = _pad_pow2(preds, target)
    return _binary_roc_padded_kernel(preds, target, valid, _rank.select_tier(preds))


def _sketch_dispatch(
    op: str, preds: Tensor, target: Tensor, valid: Tensor, tolerance: float, bits: int, kind: str
) -> Optional[Tensor]:
    """The tolerance route of the scalar AUROC/AP entry points: the certified bracket
    midpoint, or None when the exact tier must serve.

    Taken when the tier is forced to ``"sketch"`` (no width check), or when
    ``tolerance > 0``, the inputs may be read on the host, and the bracket at ``bits``
    is at most ``tolerance`` wide. The midpoint is within width/2 of the exact value;
    AUROC keeps the exact tier's 0.0 and AP its NaN when a class is absent.
    """
    forced = _rank.forced_tier()
    if forced not in (None, "sketch"):
        return None
    if forced != "sketch" and (not tolerance or tolerance <= 0 or not _is_concrete(preds, target)):
        return None
    if kind == "auroc":
        lo, hi = _rank.sketch_auroc_bracket(preds, target, valid, bits=bits)
        pos_tot = None
    else:
        lo, hi, pos_tot = _rank.sketch_ap_bracket(preds, target, valid, bits=bits)
    if forced != "sketch" and float(hi - lo) > tolerance:
        return None
    _rank.record_dispatch("sketch", op)
    with _rank.rank_scope("sketch"):
        mid = 0.5 * (lo + hi)
        return mid if pos_tot is None else torch.where(pos_tot > 0, mid, float("nan"))


def binary_auroc_exact(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    tolerance: float = 0.0,
    tolerance_bits: int = 12,
) -> Tensor:
    """Exact binary AUROC on the inputs' device; ``target`` entries < 0 are excluded.

    ``max_fpr`` in (0, 1) gives the McClish-standardized partial AUC; None or 1 the
    full area (0.0 on single-class data, as the reference's safe division gives).
    ``tolerance > 0`` lets the full area take the sketch tier when its certified
    bracket at ``tolerance_bits`` fits (:func:`_sketch_dispatch`); a partial AUC has
    no certificate and always takes the exact tier.
    """
    preds, target, valid = _pad_binary(preds, target)
    full = max_fpr is None or max_fpr == 1
    if full:
        routed = _sketch_dispatch("binary_auroc", preds, target, valid, tolerance, tolerance_bits, "auroc")
        if routed is not None:
            return routed
    tier = _rank.select_tier(preds)
    _rank.record_dispatch(tier, "binary_auroc")
    with _rank.rank_scope(tier):
        if full:
            return _binary_auroc_kernel(preds, target, valid, None, tier)
        bound = torch.full((), max_fpr, dtype=torch.float32, device=preds.device)
        return _binary_auroc_kernel(preds, target, valid, bound, tier)


def binary_average_precision_exact(
    preds: Tensor, target: Tensor, tolerance: float = 0.0, tolerance_bits: int = 12
) -> Tensor:
    """Exact binary average precision on the inputs' device; NaN with no positives.
    ``tolerance > 0`` as for :func:`binary_auroc_exact`."""
    preds, target, valid = _pad_binary(preds, target)
    routed = _sketch_dispatch("binary_ap", preds, target, valid, tolerance, tolerance_bits, "ap")
    if routed is not None:
        return routed
    tier = _rank.select_tier(preds)
    _rank.record_dispatch(tier, "binary_ap")
    with _rank.rank_scope(tier):
        return _binary_ap_kernel(preds, target, valid, tier)[0]


# ------------------------------------------------------------- one-vs-rest tiers


def _binary_auroc_with_pos(preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort") -> Tuple[Tensor, Tensor]:
    """(AUROC, positive count) of one column; absent classes score 0.0."""
    fpr0, tpr0, pos, _ = _roc_points(preds, target, valid, tier)
    return _trapz(tpr0, fpr0), pos


def _per_column(kernel, preds2d: Tensor, targets, op: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Run ``kernel(column, target, valid, tier)`` over the columns and stack; ``op``
    names the call for :func:`~metrics_tpu_torch.ops.rank.record_dispatch`."""
    tier = _rank.select_tier(preds2d[:, 0])
    if op is not None:
        _rank.record_dispatch(tier, op)
    cols = preds2d.t().contiguous()
    scores, pos = [], []
    with _rank.rank_scope(tier):
        for c in range(cols.shape[0]):
            t = targets(c)
            s, p = kernel(cols[c], t, t >= 0, tier)
            scores.append(s)
            pos.append(p)
    return torch.stack(scores), torch.stack(pos)


def _ovr(kernel, preds2d: Tensor, target: Tensor, op: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Multiclass: binarize a shared label vector one-vs-rest per class."""
    target = target.reshape(-1).to(torch.int32)
    return _per_column(kernel, preds2d, lambda c: torch.where(target >= 0, (target == c).to(torch.int32), -1), op)


def _perlabel(kernel, preds2d: Tensor, target2d: Tensor, op: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Multilabel: an independent target column (and ignore mask) per label."""
    cols = target2d.to(torch.int32).t().contiguous()
    return _per_column(kernel, preds2d, lambda c: cols[c], op)


def multiclass_auroc_exact(preds2d: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-class exact AUROC and positive counts; rows with target < 0 excluded."""
    return _ovr(_binary_auroc_with_pos, preds2d, target, "multiclass_auroc")


def multiclass_average_precision_exact(preds2d: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    return _ovr(_binary_ap_kernel, preds2d, target, "multiclass_ap")


def multilabel_auroc_exact(preds2d: Tensor, target2d: Tensor) -> Tuple[Tensor, Tensor]:
    return _perlabel(_binary_auroc_with_pos, preds2d, target2d, "multilabel_auroc")


def multilabel_average_precision_exact(preds2d: Tensor, target2d: Tensor) -> Tuple[Tensor, Tensor]:
    return _perlabel(_binary_ap_kernel, preds2d, target2d, "multilabel_ap")


# ---------------------------------------------------------------- fixed points


def binary_curve_counts(
    preds: Tensor, target: Tensor, valid: Tensor, tier: str = "sort"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The exact curve in the fixed shape of the descending sort, for the fixed-point
    metrics (recall at precision, precision at recall, specificity at sensitivity).

    Returns int32 ``fps``/``tps`` and the float32 score at every row, and ``point``,
    True on the rows that are points of the curve: the last row of each tie run of
    valid scores, in descending-score order. ``tps[-1]`` and ``fps[-1]`` are the
    positive and negative totals. One sort and one scan launch.
    """
    fps, tps, keys, boundary = _run_end_counts(preds, target, valid, tier)
    rows = torch.arange(boundary.shape[0], device=boundary.device)
    return fps, tps, keys, boundary & (rows < fps[-1] + tps[-1])
