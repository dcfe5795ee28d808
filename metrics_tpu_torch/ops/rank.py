"""Rank tier of the exact curve kernels: the order-preserving key bijection and the
reduced-payload sort.

Counterpart of ``metrics_tpu/ops/rank.py`` up to :231 (the key bijection, the tier
dispatch and ``rank_run_end_counts``). Scores map to integer keys whose ascending
order is descending score order, a total order over ±inf in which the zero-exponent
class (±0.0 and every denormal) is one key, +0.0's, as the JAX oracle's flushing
sort and compare make it one tie run. Invalid rows take the -inf key.

The JAX package keeps the keys as uint32. ``torch.sort`` does not take uint32 on
every device, so the rank tier sorts the same keys XOR 0x80000000 as int32, which
orders them alike; :func:`monotone_key_descending` returns the uint32 values
themselves, held in int64.

Dispatch: a CUDA tensor of at least ``RANK_MIN_SIZE`` rows takes the rank tier (in
place of the JAX package's TPU and unsharded gate); everything else keeps the f32
sort of ``ops/clf_curve.py``, the correctness reference. ``force_tier`` pins one.

Since the retrieval slice, also ``ranked_targets`` and ``stable_front_pack``
(:457-469), on :func:`descending_sort_key`, the key of XLA's float sort comparator.

Since the regression slice, also :func:`average_ranks`, the tie-averaged ranks of
Spearman's correlation (``metrics_tpu/functional/regression/spearman.py:_rank_data``)
for every column at once, on the segmented scan.

Since the sketch slice, also ``record_dispatch`` and ``rank_scope`` (:172-195) and
the bucket-histogram machinery and sketch tier (:235-451): per-bucket class counts of
the top ``bits`` key bits on the histogram kernel (:func:`class_bucket_counts`, two
mask-mode launches; :func:`class_bucket_counts_lanes`, the one-vs-rest lanes in two
launches of the kernel's batched mode), the certified AUROC and average-precision
brackets from them, and the tolerance route's bracket functions. The JAX package
counts in float32 pair arithmetic; so does the port, so its AUROC bounds match within
rounding. Its AP bounds do not: the JAX package's ψ expansion has a sign error
(:func:`_psi_diff`) and its upper bound leaves out runs of tied positives
(:func:`average_precision_bounds_from_hists`), so its bracket can miss the exact value;
the port does not copy either fault. Its 2-D ``hist_*_bounds`` vmap over lanes; the port's are batched tensor
ops along the last dimension of ``(C, 2^bits)``. ``record_dispatch`` counts into a
module-level counter under the JAX registry's names (the port has no ``obs`` yet):
:func:`dispatch_counts` reads it, :func:`reset_dispatch_counts` clears it.
"""
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import Tensor

#: Below this row count the f32 sort tier serves.
RANK_MIN_SIZE = 1 << 20

_EXP_FIELD = 0x7F800000
_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1
#: Sortable int32 key of -inf, also pinned for invalid rows (uint32 0xFF800000).
_NEG_INF_KEY_I32 = 0x7F800000
#: The uint32 key of -inf, as in the JAX package.
NEG_INF_KEY = 0xFF800000

_FORCED_TIER: Optional[str] = None


@torch.library.custom_op("metrics_tpu_torch::f32_bits", mutates_args=())
def _f32_bits_op(x: Tensor) -> Tensor:
    return x.contiguous().view(torch.int32).clone()


@_f32_bits_op.register_fake
def _f32_bits_fake(x: Tensor) -> Tensor:
    return torch.empty_like(x, dtype=torch.int32)


@torch.library.custom_op("metrics_tpu_torch::bits_f32", mutates_args=())
def _bits_f32_op(x: Tensor) -> Tensor:
    return x.contiguous().view(torch.float32).clone()


@_bits_f32_op.register_fake
def _bits_f32_fake(x: Tensor) -> Tensor:
    return torch.empty_like(x, dtype=torch.float32)


def _reinterpret_vmap(op):
    def rule(info, in_dims: Tuple, x: Tensor):
        return op(x.movedim(in_dims[0], 0) if in_dims[0] is not None else x), (0 if in_dims[0] is not None else None)

    return rule


torch.library.register_vmap("metrics_tpu_torch::f32_bits", _reinterpret_vmap(_f32_bits_op))
torch.library.register_vmap("metrics_tpu_torch::bits_f32", _reinterpret_vmap(_bits_f32_op))


def f32_bits(x: Tensor) -> Tensor:
    """The int32 bits of float32 ``x``. Under a ``torch.func`` transform through a custom
    op (a copy), since some PyTorch versions have no batching rule for ``view(dtype)``."""
    x = x.to(torch.float32)
    if torch._C._are_functorch_transforms_active():
        return torch.ops.metrics_tpu_torch.f32_bits(x)
    return x.contiguous().view(torch.int32)


def bits_f32(bits: Tensor) -> Tensor:
    """The float32 whose bits are int32 ``bits``: the inverse of :func:`f32_bits`."""
    bits = bits.to(torch.int32)
    if torch._C._are_functorch_transforms_active():
        return torch.ops.metrics_tpu_torch.bits_f32(bits)
    return bits.contiguous().view(torch.float32)


def _sortable_key(preds: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """int32 keys whose ascending order is descending score order (uint32 key XOR 2^31)."""
    bits = f32_bits(preds)
    # zero exponent field == zero or denormal: one tie class, keyed as +0.0
    bits = torch.where((bits & _EXP_FIELD) == 0, 0, bits)
    # sign clear: ~bits (bigger floats -> more negative keys); sign set: the magnitude bits
    key = torch.where(bits < 0, bits & 0x7FFFFFFF, ~bits)
    if valid is not None:
        key = torch.where(valid, key, _NEG_INF_KEY_I32)
    return key


def _sortable_key_to_f32(key: Tensor) -> Tensor:
    """Exact inverse of :func:`_sortable_key` (modulo the zero-class canonicalization)."""
    bits = torch.where(key < 0, ~key, key | _INT32_MIN)
    return bits_f32(bits)


def monotone_key_descending(preds: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """uint32 keys (held in int64) whose ascending order is descending score order.

    +inf -> 0x007FFFFF, ..., +0 -> 0x7FFFFFFF, ..., -inf -> 0xFF800000; ±0.0 and
    ±denormals share +0.0's key; rows with ``valid`` False take ``NEG_INF_KEY``.
    Inputs are NaN-free, as the JAX package requires.
    """
    return _sortable_key(preds, valid).to(torch.int64) + (1 << 31)


def key_to_f32_descending(keys: Tensor) -> Tensor:
    """Exact inverse of :func:`monotone_key_descending` (modulo -0 canonicalization)."""
    return _sortable_key_to_f32((keys - (1 << 31)).to(torch.int32))


@contextmanager
def force_tier(tier: Optional[str]) -> Iterator[None]:
    """Pin the tier to ``"rank"``, ``"sort"`` or ``"sketch"`` (None restores auto).

    ``"sketch"`` applies to the scalar AUROC/AP entry points (``ops/clf_curve.py``),
    which then serve the bracket midpoint without the width check; every other op
    sees :func:`select_tier` take it as ``"sort"``.
    """
    global _FORCED_TIER
    if tier not in (None, "rank", "sort", "sketch"):
        raise ValueError(f"unknown rank tier: {tier!r}")
    prev = _FORCED_TIER
    _FORCED_TIER = tier
    try:
        yield
    finally:
        _FORCED_TIER = prev


def forced_tier() -> Optional[str]:
    """The tier pinned by :func:`force_tier`, or None under auto dispatch."""
    return _FORCED_TIER


def select_tier(x: Tensor) -> str:
    """A CUDA tensor of at least ``RANK_MIN_SIZE`` elements -> "rank", else "sort".

    Under ``torch.func.vmap`` ``numel`` is one sample's: a stack of copies takes the
    tier that each copy alone would."""
    if _FORCED_TIER is not None:
        return "sort" if _FORCED_TIER == "sketch" else _FORCED_TIER
    if x.numel() >= RANK_MIN_SIZE and x.device.type == "cuda":
        return "rank"
    return "sort"


_DISPATCH_COUNTS: Counter = Counter()


def record_dispatch(tier: str, op: str) -> None:
    """Count which tier served a call of ``op``: ``rank/dispatch/<tier>`` and
    ``rank/op/<op>``, the JAX package's registry names."""
    _DISPATCH_COUNTS[f"rank/dispatch/{tier}"] += 1
    _DISPATCH_COUNTS[f"rank/op/{op}"] += 1


def dispatch_counts() -> Dict[str, int]:
    """The counts :func:`record_dispatch` has kept since the last reset."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    _DISPATCH_COUNTS.clear()


def rank_scope(tier: str):
    """A ``tm.rank/<tier>`` range in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(f"tm.rank/{tier}")


def rank_run_end_counts(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Rank-tier ``(fps, tps, sk, boundary)``, bit-identical to the f32 sort tier
    (``ops/clf_curve.py:_run_end_counts``).

    Sorts the int32 keys and gathers a uint8 label (0 negative, 1 positive, 2
    invalid) by the sort's indices. Run boundaries depend on the key multiset alone
    and ``tps``/``fps`` read only run-end counts, so within-run order does not
    matter; ``sk`` comes back through the exact inverse of the key map.
    """
    from metrics_tpu_torch.ops.clf_curve import _fps_tps_from_sorted

    key = _sortable_key(preds, valid)
    lab = torch.where(valid, (target == 1).to(torch.uint8), 2)
    skey, order = torch.sort(key)
    slab = lab[order]
    fps, tps, boundary = _fps_tps_from_sorted(skey, slab == 1, (slab != 2).sum(dtype=torch.int32))
    return fps, tps, _sortable_key_to_f32(skey), boundary


# ------------------------------------------------- bucket histogram machinery


def _bucket_ids(keys: Tensor, bits: int) -> Tensor:
    """int32 bucket of each uint32 key (held in int64): its top ``bits`` bits."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return (keys >> (32 - bits)).to(torch.int32)


def bucket_counts(keys: Tensor, bits: int, weights: Optional[Tensor] = None) -> Tensor:
    """Histogram of the top ``bits`` bits of uint32 keys (held in int64) over ``2^bits``
    bins: int32 for counts and bool masks (the kernel's count and mask modes on the
    card up to 2^14 bins, the scatter-add path above), float32 for float32 weights."""
    from metrics_tpu_torch.ops.histogram import bincount, bincount_weighted

    buckets = _bucket_ids(keys, bits)
    if weights is None:
        return bincount(buckets, 1 << bits)
    return bincount_weighted(buckets, weights, 1 << bits)


def class_bucket_counts(keys: Tensor, pos_mask: Tensor, valid: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    """(pos_hist, neg_hist) over the top ``bits`` key bits; invalid rows drop out. Two
    mask-mode launches on the card, as the JAX package's two histograms."""
    pos_hist = bucket_counts(keys, bits, pos_mask & valid)
    all_hist = bucket_counts(keys, bits, valid)
    return pos_hist, all_hist - pos_hist


def class_bucket_counts_lanes(keys: Tensor, pos_mask: Tensor, valid: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    """:func:`class_bucket_counts` of every lane of ``(C, N)`` keys and masks at once:
    ``(C, 2^bits)`` histograms from two launches of the kernel's batched mode, bit-equal
    to a loop of the one-lane form (the JAX package's two launches a lane)."""
    from metrics_tpu_torch.ops.histogram import bincount_batched

    buckets = _bucket_ids(keys, bits).contiguous()
    pos_hist = bincount_batched(buckets, (pos_mask & valid).contiguous(), 1 << bits)
    all_hist = bincount_batched(buckets, valid.contiguous(), 1 << bits)
    return pos_hist, all_hist - pos_hist


def cross_bucket_pair_stats(pos_hist: Tensor, neg_hist: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact-bucket (cross_gt_pairs, same_bucket_pairs) of the last dimension's buckets.

    Buckets are in descending score order, so a positive outscores every negative in a
    higher bucket: ``cross_gt = sum_b pos[b] * sum_{b' > b} neg[b']``. In float32, as
    in the JAX package (pair counts reach N^2; relative error ~1e-7).
    """
    neg_f = neg_hist.to(torch.float32)
    neg_above = torch.flip(torch.cumsum(torch.flip(neg_f, [-1]), -1), [-1]) - neg_f
    pos_f = pos_hist.to(torch.float32)
    return torch.sum(pos_f * neg_above, -1), torch.sum(pos_f * neg_f, -1)


def auroc_bounds_from_hists(pos_hist: Tensor, neg_hist: Tensor) -> Tuple[Tensor, Tensor]:
    """Certified [lower, upper] AUROC bounds from per-class bucket histograms (along the
    last dimension); both 0 when a class is absent, the exact tier's degenerate 0.0."""
    cross, same = cross_bucket_pair_stats(pos_hist, neg_hist)
    p = torch.sum(pos_hist, -1).to(torch.float32)
    q = torch.sum(neg_hist, -1).to(torch.float32)
    denom = torch.clamp(p * q, min=1.0)
    both = (p > 0) & (q > 0)
    return torch.where(both, cross / denom, 0.0), torch.where(both, (cross + same) / denom, 0.0)


def bucketed_auroc_bounds(
    preds: Tensor, target: Tensor, valid: Optional[Tensor] = None, bits: int = 12
) -> Tuple[Tensor, Tensor]:
    """[lower, upper] AUROC bounds from one histogram pass over the scores (no sort)."""
    if valid is None:
        valid = torch.ones(preds.shape, dtype=torch.bool, device=preds.device)
    keys = monotone_key_descending(preds, valid)
    return auroc_bounds_from_hists(*class_bucket_counts(keys, target == 1, valid, bits))


def _psi_diff(a: Tensor, p: Tensor) -> Tensor:
    """``ψ(a+p) − ψ(a)`` without cancellation: the asymptotic expansion's small-difference
    form for ``a >= 8`` (truncation below 1/(120 a^4)), the digamma difference below.

    From ``ψ(x) ~ ln x − 1/(2x) − 1/(12x²)`` the difference is ``log1p(p/a) + p/(2ab) +
    p(a+b)/(12a²b²)``. The JAX package subtracts the last term, an error of ``p/(3a³)``
    (2e-3 at a = 8, p = 10) that can move its AP bracket off the exact value; the port
    adds it (a deliberate deviation).
    """
    b = a + p
    stable = torch.log1p(p / a) + p / (2.0 * a * b) + p * (a + b) / (12.0 * a * a * b * b)
    exact = torch.special.digamma(b) - torch.special.digamma(a)
    return torch.where(a < 8.0, exact, stable)


def average_precision_bounds_from_hists(pos_hist: Tensor, neg_hist: Tensor) -> Tuple[Tensor, Tensor]:
    """Certified [lower, upper] bounds of the exact tier's tie-collapsed average precision
    from per-class bucket histograms (along the last dimension).

    A bucket's ``p`` positives follow ``P`` positives and ``N`` negatives of higher
    buckets, and each is credited the precision at the end of its tie run. The least
    credit is the arrangement with the bucket's ``n`` negatives first and no ties,
    ``Σ_{i=1..p} (P+i)/(P+N+n+i) = p − (N+n)·(ψ(P+N+n+p+1) − ψ(P+N+n+1))``; the most is
    one tie run of the ``p`` positives first, ``p·(P+p)/(P+N+p)``, as no positive's run can
    end with more positives or fewer negatives above it. The JAX package's upper bound is
    the positives-first arrangement without ties, ``p − N·(ψ(P+N+p+1) − ψ(P+N+1))``,
    which a run of tied positives exceeds (eight negatives then three tied positives: AP
    3/11 against its 0.1946); the port does not copy that fault.
    """
    pos_f = pos_hist.to(torch.float32)
    neg_f = neg_hist.to(torch.float32)
    p_prev = torch.cumsum(pos_f, -1) - pos_f
    n_prev = torch.cumsum(neg_f, -1) - neg_f
    t_prev = p_prev + n_prev
    best = pos_f * (p_prev + pos_f) / torch.clamp(t_prev + pos_f, min=1.0)
    worst = pos_f - (n_prev + neg_f) * _psi_diff(t_prev + neg_f + 1.0, pos_f)
    p_total = torch.sum(pos_f, -1)
    denom = torch.clamp(p_total, min=1.0)
    any_pos = p_total > 0
    return (torch.where(any_pos, torch.sum(worst, -1) / denom, 0.0),
            torch.where(any_pos, torch.sum(best, -1) / denom, 0.0))


# ------------------------------------------------- sketch tier (tolerance route)

#: Default histogram bit depth of the tolerance route, as ``StreamingAUROCBound``'s.
SKETCH_DEFAULT_BITS = 12


def hist_class_counts(
    preds: Tensor, pos_mask: Tensor, valid: Tensor, bits: int = SKETCH_DEFAULT_BITS
) -> Tuple[Tensor, Tensor]:
    """One lane of sketch-tier accumulation: scores -> (pos_hist, neg_hist)."""
    return class_bucket_counts(monotone_key_descending(preds, valid), pos_mask, valid, bits)


def sketch_auroc_bracket(
    preds: Tensor, target: Tensor, valid: Tensor, bits: int = SKETCH_DEFAULT_BITS
) -> Tuple[Tensor, Tensor]:
    """Certified [lower, upper] AUROC bracket in one histogram pass (no sort)."""
    return auroc_bounds_from_hists(*hist_class_counts(preds, target == 1, valid, bits))


def sketch_ap_bracket(
    preds: Tensor, target: Tensor, valid: Tensor, bits: int = SKETCH_DEFAULT_BITS
) -> Tuple[Tensor, Tensor, Tensor]:
    """Certified [lower, upper] average-precision bracket and the positive count
    (callers map no positives to the exact tier's NaN)."""
    pos_hist, neg_hist = hist_class_counts(preds, target == 1, valid, bits)
    lo, hi = average_precision_bounds_from_hists(pos_hist, neg_hist)
    return lo, hi, torch.sum(pos_hist)


#: the JAX package's names of the compute half; ``(C, 2^bits)`` histograms give one
#: pair of bounds per lane
hist_auroc_bounds = auroc_bounds_from_hists
hist_ap_bounds = average_precision_bounds_from_hists


# --------------------------------------------------------- sort-slim helpers


def descending_sort_key(x: Tensor) -> Tensor:
    """int32 keys whose ascending stable order is the order of XLA's stable sort of ``-x``.

    That comparator (the JAX package's ``lax.sort`` on the CPU) treats ±0.0 and every
    denormal as one value and sorts NaN after everything: :func:`_sortable_key`, with
    NaN mapped to the largest key.
    """
    x = x.to(torch.float32)
    return torch.where(torch.isnan(x), _INT32_MAX, _sortable_key(x))


def ranked_targets(preds: Tensor, target: Tensor) -> Tensor:
    """``target`` reordered by descending ``preds`` along the last axis; stable, so
    equal scores keep their original order (ties as in :func:`descending_sort_key`)."""
    order = torch.sort(descending_sort_key(preds), dim=-1, stable=True).indices
    return torch.gather(target, -1, order)


def stable_front_pack(mask: Tensor, *cols: Tensor) -> Tuple[Tensor, ...]:
    """Entries where ``mask`` is True first, then the others, each group in its order,
    along the last axis (``cols`` have ``mask``'s shape).

    A stable partition needs no sort: each entry's destination is its rank among the
    entries of its group (a cumulative sum), and one scatter per column puts it there.
    It reads nothing on the host and runs under ``torch.func.vmap``.
    """
    mask = mask.to(torch.bool)
    kept = torch.cumsum(mask, -1)
    dropped = torch.cumsum(~mask, -1)
    dest = torch.where(mask, kept - 1, kept[..., -1:] + dropped - 1)
    return tuple(torch.zeros_like(c).scatter(-1, dest, c) for c in cols)


# --------------------------------------------------------- tie-averaged ranks


def _ascending_total_key(x: Tensor) -> Tensor:
    """int32 keys whose signed order is the ascending order of float32 ``x``, as XLA's
    sort comparator orders it (``lax._float_to_int_for_sort``): ±0.0 share 0's key and
    every NaN takes the largest key, after +inf. Denormals keep keys of their own."""
    x = x.to(torch.float32).contiguous()
    bits = f32_bits(x)
    key = torch.where(bits < 0, bits ^ _INT32_MAX, bits)  # negatives: flip the magnitude bits
    key = torch.where(x == 0, 0, key)
    return torch.where(torch.isnan(x), _INT32_MAX, key)


def _tie_runs(x: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The sorted packed keys of the columns of ``x`` ``(N, C)``, the sort's order, the
    tie-run start and end flags and the row positions that :func:`average_ranks` scans."""
    n, c = x.shape
    total = n * c
    key = _ascending_total_key(x.t().reshape(-1))  # column-major: row i of column j at j * n + i
    col = torch.arange(c, dtype=torch.int64, device=x.device).repeat_interleave(n)
    skey, order = torch.sort(col * (1 << 32) + (key.to(torch.int64) - _INT32_MIN), stable=True)
    new_run = torch.ones(total, dtype=torch.bool, device=x.device)
    new_run[1:] = (skey[1:] != skey[:-1]) | ((skey[1:] & 0xFFFFFFFF) == _INT32_MAX - _INT32_MIN)  # NaN
    is_last = torch.ones_like(new_run)
    is_last[:-1] = new_run[1:]
    pos = torch.arange(total, dtype=torch.int32 if total < (1 << 31) else torch.int64, device=x.device)
    return skey, order, new_run, is_last, pos


def average_ranks(x: Tensor) -> Tensor:
    """1-based tie-averaged ranks of every column of ``x`` ``(N, C)``, as float64 ``(N, C)``.

    Ties are the JAX package's: adjacent sorted float32 values with ``a != b`` False,
    so ±0.0 form one run and each NaN (sorted last, in row order) a run of its own.
    One stable sort of packed (column, value key) int64 keys orders all C columns;
    tie-run starts (a column start is one) flag a forward ``min`` scan of the row
    position, which gives each run's first position, and run ends a reverse ``max``
    scan, which gives its last: two :func:`~metrics_tpu_torch.ops.segment.segment_multi_scan`
    launches on the card whatever C. A rank is ``(first + last) / 2 + 1`` less the
    column's offset, exact in float64 (the JAX package sums ranks in float32, exact
    while a run's sum stays below 2^24).
    """
    from metrics_tpu_torch.ops.segment import segment_multi_scan

    n, c = x.shape
    if n * c == 0:
        return torch.empty((n, c), dtype=torch.float64, device=x.device)
    skey, order, new_run, is_last, pos = _tie_runs(x)
    (first,) = segment_multi_scan((pos,), new_run, ops=("min",))
    (last,) = segment_multi_scan((pos,), is_last, ops=("max",), reverse=True)
    offset = (skey >> 32) * n
    ranked = (first.to(torch.float64) + last.to(torch.float64)) / 2 + 1 - offset.to(torch.float64)
    ranks = torch.empty(n * c, dtype=torch.float64, device=x.device)
    ranks[order] = ranked
    return ranks.view(c, n).t()
