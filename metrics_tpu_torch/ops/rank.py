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

Not in this slice: the bucket-histogram machinery and the sketch tier (:235-451),
``record_dispatch`` and ``rank_scope``.
"""
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

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
    """Pin the exact-curve tier to ``"rank"`` or ``"sort"`` (None restores auto).

    The JAX package's ``"sketch"`` tier is not ported: pinning it raises.
    """
    global _FORCED_TIER
    if tier == "sketch":
        raise NotImplementedError("the sketch tier of the exact curve kernels is not ported yet")
    if tier not in (None, "rank", "sort"):
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
        return _FORCED_TIER
    if x.numel() >= RANK_MIN_SIZE and x.device.type == "cuda":
        return "rank"
    return "sort"


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
