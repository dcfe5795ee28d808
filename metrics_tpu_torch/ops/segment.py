"""Fused segmented multi-scan: every integer per-segment running statistic in one pass.

Counterpart of the first half of ``metrics_tpu/ops/segment.py`` (``segment_multi_scan``
:352-437 and its tiers). There the Pallas kernel ``_multi_scan_pallas`` serves TPU
inputs of at least 2^18 rows, and XLA scans (native per-lane scans, an
``associative_scan`` tuple carry) cover the rest. Here there are two paths, chosen
by where the lanes lie:

- **CPU tensors:** :func:`_plain_multi_scan`, plain PyTorch. It is also the kernel's
  reference in the tests and in ``chip_smoke.py``.
- **CUDA tensors:** the hand-written kernel in ``csrc/segment_scan.cu`` through
  :func:`segment_scan_cuda`, at every N. There is no fallback: a CUDA lane the
  kernel does not take raises.

Integer lanes only: int add/min/max are exact under any association, so the kernel,
the plain version and every tier of the JAX package agree bit for bit. Sums wrap.

Under a ``torch.func`` transform (``vmap`` of an exact curve over bootstrap copies or
classes) the scan goes through the custom op ``metrics_tpu_torch::segment_scan``,
whose batching rule is the counterpart of the JAX package's batched scan: ``B`` scans
of ``N`` rows are one scan of ``B * N`` rows whose segment flags also mark each
row's first element (its last with ``reverse``), so no segment crosses a row. On the
card that is one kernel launch for the whole batch; on the CPU the plain version.

The retrieval half (``_segment_cumsum_*`` :58-147, ``_scan_retrieval_scores``
:451-608, ``grouped_retrieval_scores`` :611) follows the scan. Its integer passes
all go through :func:`segment_multi_scan`, so on the card every one is a kernel
launch with real segment flags: pass A (two int32 lanes, three with MRR's ``min``
lane), pass B (the rank-gated count), and r_precision's reverse pass over
segment-last flags and its gated pass. Its float running sums stay block-local
(:func:`_segment_cumsum_float`), in plain PyTorch as the JAX package leaves them
to XLA.
"""
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build
from metrics_tpu_torch.ops.rank import _INT32_MIN, _sortable_key_to_f32, descending_sort_key

_OP_CODES = {"sum": 0, "min": 1, "max": 2}  # the kernel's op codes
_INT32_MAX = (1 << 31) - 1
_SCAN_OPS = tuple(_OP_CODES)
#: integer lane dtypes the entry point takes; the kernel itself runs int32 or int64
_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)
KERNEL_MAX_LANES = 4


def _identity(op: str, dtype: torch.dtype) -> int:
    if op == "sum":
        return 0
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _combine(op: str, a: Tensor, b: Tensor) -> Tensor:
    if op == "sum":
        return a + b
    if op == "min":
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def _plain_multi_scan(
    values: Sequence[Tensor], flags: Optional[Tensor], ops: Sequence[str], reverse: bool = False
) -> Tuple[Tensor, ...]:
    """Plain PyTorch segmented inclusive scans (any device, any integer dtype).

    ``flags`` marks segment-start rows (segment last rows with ``reverse``), or is
    None for one global segment, which takes ``cumsum``/``cummin``/``cummax``. Real
    flags take a log-step (Hillis-Steele) doubling over the whole array under the
    monoid ``(fa, a) + (fb, b) = (fa | fb, fb ? b : op(a, b))``.
    """
    values = [v.flip(0) if reverse else v for v in values]
    if flags is None:
        outs = []
        for op, v in zip(ops, values):
            if op == "sum":
                outs.append(torch.cumsum(v, 0, dtype=v.dtype))
            elif op == "min":
                outs.append(torch.cummin(v, 0).values)
            else:
                outs.append(torch.cummax(v, 0).values)
    else:
        f = (flags.flip(0) if reverse else flags).to(torch.bool)
        outs = list(values)
        n = f.shape[0]
        d = 1
        while d < n:
            head = torch.ones(d, dtype=torch.bool, device=f.device)
            f_prev = torch.cat([head, f[:-d]])
            for j, (op, v) in enumerate(zip(ops, outs)):
                shifted = torch.cat([torch.full((d,), _identity(op, v.dtype), dtype=v.dtype, device=v.device), v[:-d]])
                outs[j] = torch.where(f, v, _combine(op, shifted, v))
            f = f | f_prev
            d *= 2
    return tuple(o.flip(0) if reverse else o for o in outs)


class SegmentScanKernel:
    """Wrapper of the CUDA segmented multi-scan kernel: checks, launch, and a count.

    ``launches`` grows by one each time the kernel is launched, and nowhere else: a
    call inside a CUDA-graph capture only records the launch, and each replay counts
    it (``core/fused.py:CapturedStep``).

    A launch takes at most :meth:`max_rows` rows: one CTA a tile, and a grid of at
    most 2^31 - 1 tiles.
    """

    def __init__(self) -> None:
        self.launches = 0
        self._fns = None

    def _functions(self):
        if self._fns is None:
            lib = _build.load("segment_scan")
            self._fns = (lib.tm_segment_scan, lib.tm_segment_scan_scratch_bytes, lib.tm_segment_scan_tile_rows)
        return self._fns

    def tile_rows(self, k: int, dtype: torch.dtype) -> int:
        """Rows of one kernel tile for ``k`` lanes of ``dtype`` (builds the kernel if needed)."""
        return self._functions()[2](k, int(dtype == torch.int64))

    def max_rows(self, k: int, dtype: torch.dtype) -> int:
        """The most rows one launch of ``k`` lanes of ``dtype`` takes (2^31 - 1 tiles)."""
        return _INT32_MAX * self.tile_rows(k, dtype)

    def __call__(
        self, values: Sequence[Tensor], flags: Optional[Tensor], ops: Sequence[str], reverse: bool = False
    ) -> Tuple[Tensor, ...]:
        """Segmented inclusive scans of 1 to 4 CUDA lanes in one launch.

        Lanes are 1-D, contiguous, of one length and one dtype (int32 or int64), on
        one device; ``flags`` is None or a bool/uint8 lane of the same length there.
        Outputs have the lanes' dtype.
        """
        values = tuple(values)
        ops = tuple(ops)
        if not 1 <= len(values) <= KERNEL_MAX_LANES:
            raise ValueError(f"segment scan kernel: 1 to {KERNEL_MAX_LANES} lanes per launch, got {len(values)}")
        if len(ops) != len(values) or any(op not in _OP_CODES for op in ops):
            raise ValueError(f"segment scan kernel: one op of {_SCAN_OPS} per lane, got {ops}")
        first = values[0]
        if first.device.type != "cuda":
            raise ValueError(f"segment scan kernel: lanes must be CUDA tensors, got one on {first.device}")
        if first.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"segment scan kernel: lanes must be int32 or int64, got {first.dtype}")
        n = first.shape[0] if first.dim() == 1 else -1
        for v in values:
            if v.device != first.device or v.dtype != first.dtype or v.dim() != 1 or v.shape[0] != n:
                raise ValueError("segment scan kernel: lanes must be 1-D, of one length, dtype and device")
            if not v.is_contiguous():
                raise ValueError("segment scan kernel: lanes must be contiguous")
        if flags is not None:
            if flags.device != first.device or flags.dim() != 1 or flags.shape[0] != n:
                raise ValueError("segment scan kernel: flags must be 1-D, of the lanes' length and device")
            if flags.dtype not in (torch.bool, torch.uint8) or not flags.is_contiguous():
                raise TypeError(f"segment scan kernel: flags must be contiguous bool or uint8, got {flags.dtype}")
        outs = tuple(torch.empty_like(v) for v in values)
        if n == 0:
            return outs
        fn, scratch_bytes, _ = self._functions()
        k, is64 = len(values), int(first.dtype == torch.int64)
        if n > self.max_rows(k, first.dtype):
            raise ValueError(f"segment scan kernel: at most {self.max_rows(k, first.dtype)} rows per launch, got {n}")
        # tile counter, status words and tile values; the call zeroes what must start at 0
        scratch = torch.empty(scratch_bytes(k, is64, n), dtype=torch.uint8, device=first.device)
        in_ptrs = (ctypes.c_void_p * k)(*[v.data_ptr() for v in values])
        out_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
        op_codes = (ctypes.c_int * k)(*[_OP_CODES[op] for op in ops])
        flag_ptr = None if flags is None else flags.data_ptr()
        err = _build.call_on_device(
            first.device,
            lambda stream: fn(
                k, in_ptrs, out_ptrs, op_codes, is64, flag_ptr, n, int(bool(reverse)), scratch.data_ptr(), stream
            ),
        )
        if err != 0:
            raise RuntimeError(f"segment scan kernel launch failed with CUDA error {err}")
        _build.note_launch(self)
        return outs


segment_scan_cuda = SegmentScanKernel()


def _kernel_dtype(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """One kernel dtype for all lanes: int32 unless some lane is int64.

    Narrower lanes widen and their results narrow back: min and max are exact under
    widening, and a wrapping sum truncated to fewer bits equals the narrow wrapping
    sum.
    """
    return torch.int64 if torch.int64 in dtypes else torch.int32


def segment_multi_scan(
    values: Sequence[Tensor],
    new_seg: Optional[Tensor],
    *,
    ops: Optional[Sequence[str]] = None,
    reverse: bool = False,
) -> Tuple[Tensor, ...]:
    """All per-segment inclusive running statistics in one pass over sorted rows.

    ``values`` is a sequence of equal-length INTEGER lanes; ``ops`` names each lane's
    reduction (``"sum"`` by default, ``"min"``, ``"max"``). ``new_seg`` marks
    segment-start rows; with ``reverse=True`` it marks segment LAST rows and the
    result is the within-segment inclusive SUFFIX statistic. ``new_seg=None`` means
    one global segment. Outputs keep each lane's dtype.

    A CUDA lane goes to the kernel (one launch for up to four lanes); CPU lanes go to
    :func:`_plain_multi_scan`.
    """
    values = tuple(values)
    if not values:
        raise ValueError("segment_multi_scan needs at least one values array")
    ops = ("sum",) * len(values) if ops is None else tuple(ops)
    if len(ops) != len(values):
        raise ValueError(f"got {len(values)} values arrays but {len(ops)} ops")
    for op, v in zip(ops, values):
        if op not in _SCAN_OPS:
            raise ValueError(f"unknown scan op {op!r}; expected one of {_SCAN_OPS}")
        if v.dtype not in _INT_DTYPES:
            raise ValueError(
                f"segment_multi_scan is integer-only (exact under reassociation); got {v.dtype}."
            )
    device, n = values[0].device, values[0].shape
    for v in values:
        if v.device != device or v.shape != n or v.dim() != 1:
            raise ValueError("segment_multi_scan: lanes must be 1-D, of one length and on one device")
    if new_seg is not None and (new_seg.device != device or new_seg.shape != n):
        raise ValueError("segment_multi_scan: new_seg must have the lanes' length and device")
    if torch._C._are_functorch_transforms_active() or _build.faking(*values):
        codes = [_OP_CODES[op] for op in ops]
        return tuple(torch.ops.metrics_tpu_torch.segment_scan(list(values), new_seg, codes, reverse))
    return _scan_direct(values, new_seg, ops, reverse)


def _scan_direct(
    values: Sequence[Tensor], new_seg: Optional[Tensor], ops: Sequence[str], reverse: bool
) -> Tuple[Tensor, ...]:
    """The scan of 1-D lanes: the kernel for CUDA lanes, the plain version for CPU lanes."""
    if values[0].device.type != "cuda":
        return _plain_multi_scan(values, new_seg, ops, reverse)

    dtype = _kernel_dtype([v.dtype for v in values])
    flags = None if new_seg is None else new_seg.to(torch.bool).contiguous()
    outs = []
    for start in range(0, len(values), KERNEL_MAX_LANES):
        lanes = [v.to(dtype).contiguous() for v in values[start:start + KERNEL_MAX_LANES]]
        outs.extend(segment_scan_cuda(lanes, flags, ops[start:start + KERNEL_MAX_LANES], reverse))
    return tuple(o.to(v.dtype) for o, v in zip(outs, values))


@torch.library.custom_op("metrics_tpu_torch::segment_scan", mutates_args=())
def _segment_scan_op(values: List[Tensor], flags: Optional[Tensor], ops: List[int], reverse: bool) -> List[Tensor]:
    """The scan as a custom op (:func:`_scan_direct` of 1-D lanes, ``ops`` as the
    kernel's op codes); its outputs never alias its inputs."""
    outs = _scan_direct(values, flags, [_SCAN_OPS[op] for op in ops], reverse)
    return [o.clone() if o is v else o for o, v in zip(outs, values)]


@_segment_scan_op.register_fake
def _segment_scan_fake(values: List[Tensor], flags: Optional[Tensor], ops: List[int], reverse: bool) -> List[Tensor]:
    return [torch.empty_like(v) for v in values]


def _segment_scan_vmap(info, in_dims: Tuple, values: List[Tensor], flags: Optional[Tensor], ops: List[int],
                       reverse: bool):
    """Batching rule: ``B`` scans of ``N`` rows are one scan of ``B * N`` rows, each row
    a segment of its own (its first element flagged, its last with ``reverse``) within
    which the caller's flags still cut."""
    batch = info.batch_size
    value_dims, flag_dim = in_dims[0], in_dims[1]

    def rows(x: Tensor, dim: Optional[int]) -> Tensor:
        return x.movedim(dim, 0) if dim is not None else x.unsqueeze(0).expand(batch, *x.shape)

    lanes = [rows(v, d) for v, d in zip(values, value_dims)]
    n = lanes[0].shape[1]
    edge = torch.zeros((batch, n), dtype=torch.bool, device=lanes[0].device)
    edge[:, -1 if reverse else 0] = True
    if flags is not None:
        edge = edge | rows(flags, flag_dim).to(torch.bool)
    outs = _segment_scan_op([lane.reshape(-1) for lane in lanes], edge.reshape(-1), ops, reverse)
    return [o.reshape(batch, n) for o in outs], [0] * len(outs)


torch.library.register_vmap("metrics_tpu_torch::segment_scan", _segment_scan_vmap)


# ------------------------------------------------------------------ retrieval half


def _segment_cumsum_nonneg(values: Tensor, new_seg: Tensor) -> Tensor:
    """Within-segment inclusive cumsum of NON-NEGATIVE values, in their dtype.

    The global cumsum never decreases, so one ``cummax`` carries each segment's base
    (the global sum just before it) to its rows. Integer lanes only for exactness:
    a float global sum loses ``ulp(global)`` per segment (:func:`_segment_cumsum_float`).
    """
    g = torch.cumsum(values, 0, dtype=values.dtype)
    base = torch.cummax(torch.where(new_seg, g - values, torch.zeros_like(g)), 0).values
    return g - base


def _segment_cumsum_float(values: Tensor, new_seg: Tensor, block: int = 2048) -> Tensor:
    """Within-segment inclusive cumsum of float values, any sign, at block-local precision.

    Rows split into blocks of ``block``: each block's segmented cumsum (sign-split
    cumsum/cummax-base trick) runs on its own, so no intermediate exceeds a block's
    or a segment's sum. The carry of the open segment across blocks is the affine
    reset composition ``c -> m_i * c + a_i`` (``m_i`` 0 where block i holds a segment
    start), scanned over the block summaries by log-step doubling. The summation
    order differs from the JAX package's ``associative_scan``: equal to a tolerance.
    """
    n = values.shape[0]
    pad = (-n) % block
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
        # padding rows open their own segments: they never extend a carry
        new_seg = torch.cat([new_seg, new_seg.new_ones(pad)])
    nb = values.shape[0] // block
    v = values.reshape(nb, block)
    seg = new_seg.reshape(nb, block)

    def inblock(x: Tensor) -> Tensor:
        g = torch.cumsum(x, 1)
        return g - torch.cummax(torch.where(seg, g - x, torch.zeros_like(g)), 1).values

    within = inblock(v.clamp_min(0.0)) - inblock((-v).clamp_min(0.0))
    m = (~seg.any(1)).to(values.dtype)
    a = within[:, -1]
    d = 1
    while d < nb:  # inclusive scan of (m, a) under (f then g) = (gm * fm, gm * fa + ga)
        a = torch.cat([a[:d], m[d:] * a[:-d] + a[d:]])
        m = torch.cat([m[:d], m[d:] * m[:-d]])
        d *= 2
    carry = torch.cat([a.new_zeros(1), a[:-1]])
    before_first = torch.cumsum(seg, 1) == 0  # rows that extend the carried-in segment
    out = within + torch.where(before_first, carry[:, None], 0.0)
    return out.reshape(-1)[:n]


def _segment_suffix_sum_nonneg(values: Tensor, is_last: Tensor) -> Tensor:
    """Within-segment inclusive SUFFIX sum of non-negative values (``is_last`` marks
    each segment's last row): the prefix form on the flipped rows."""
    return _segment_cumsum_nonneg(values.flip(0), is_last.flip(0)).flip(0)


# every retrieval metric's per-query value is a segmented-scan read at the segment's
# last row: no scatters, one or two sorts and a few fused scan passes
_SCAN_METRICS = frozenset(
    {
        "average_precision", "reciprocal_rank", "precision", "recall", "hit_rate",
        "fall_out", "ndcg", "r_precision",
    }
)


def _sort_by_query(indexes: Tensor, key: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """One stable sort by ``(indexes, key)``: sorted indexes, sorted keys, order.

    The int32 query id is the high word of an int64 key in signed order (fill rows
    with index -1 come first) and the int32 ``key`` its low word, biased to unsigned.
    Both columns come back out of the sorted key: no gather.
    """
    packed = indexes.to(torch.int64) * (1 << 32) + (key.to(torch.int64) - _INT32_MIN)
    skey, order = torch.sort(packed, stable=True)
    low = (skey & 0xFFFFFFFF) + _INT32_MIN
    return skey >> 32, low.to(torch.int32), order


def _scan_retrieval_scores(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    metric: str,
    top_k: Optional[int],
    adaptive_k: bool,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-query score at each segment's LAST row (0 / ``valid`` False elsewhere).

    Rows sort by (query, descending score), stable, as the JAX package's two-key
    ``lax.sort`` of ``(indexes, -preds, target)``. Pass A scans every statistic that
    does not depend on the within-query rank in one launch: the rank (a sum of
    ones), the relevant (or, for fall-out, non-relevant) count and, for MRR, the
    first relevant row (a ``min``). A statistic gated on the rank or on the query's
    total needs a pass of its own: a data dependency, not a missed fusion.
    """
    n = indexes.shape[0]
    device = indexes.device
    s_idx, _, order = _sort_by_query(indexes, descending_sort_key(preds))
    s_target = target[order]
    new_seg = torch.ones(n, dtype=torch.bool, device=device)
    new_seg[1:] = s_idx[1:] != s_idx[:-1]
    is_last = torch.ones(n, dtype=torch.bool, device=device)
    is_last[:-1] = new_seg[1:]
    pos = torch.arange(n, dtype=torch.int32, device=device)

    # counts are int32 lanes: exact to 2^31 rows; cast to float32 at the read points
    binary_i = (s_target > 0).to(torch.int32)
    binary_t = binary_i.to(torch.float32)

    # ---- pass A: one launch
    a_vals = [torch.ones(n, dtype=torch.int32, device=device)]
    a_ops = ["sum"]
    if metric == "fall_out":
        nonrel = 1 - binary_i
        a_vals.append(nonrel)
    else:
        a_vals.append(binary_i)
    a_ops.append("sum")
    if metric == "reciprocal_rank":
        # 1-based position of the segment's first relevant row, read where n_pos > 0
        a_vals.append(torch.where(binary_i > 0, pos + 1, (1 << 31) - 1).to(torch.int32))
        a_ops.append("min")
    a_out = segment_multi_scan(a_vals, new_seg, ops=a_ops)
    rank = a_out[0]  # 1-based position within its segment
    in_k = None if top_k is None else rank <= top_k

    def gated(x: Tensor) -> Tensor:
        return x if in_k is None else x * in_k.to(torch.int32)

    valid = is_last & (s_idx >= 0)
    if metric == "fall_out":
        cum_nonrel = a_out[1].to(torch.float32)
        if top_k is None:
            cum_nonrel_k = cum_nonrel
        else:
            (cum_nonrel_k_i,) = segment_multi_scan((gated(nonrel),), new_seg)  # pass B
            cum_nonrel_k = cum_nonrel_k_i.to(torch.float32)
        n_neg = torch.where(is_last, cum_nonrel, 0.0)
        scores = torch.where(is_last & (n_neg > 0), cum_nonrel_k / n_neg.clamp_min(1.0), 0.0)
        return scores, n_neg, valid  # the n_positive slot counts negatives for empty handling

    cum_rel_i = a_out[1]
    cum_rel = cum_rel_i.to(torch.float32)
    cum_rel_k = cum_rel
    if top_k is not None and metric in ("average_precision", "precision", "recall", "hit_rate"):
        (cum_rel_k_i,) = segment_multi_scan((gated(binary_i),), new_seg)  # pass B: rank-gated
        cum_rel_k = cum_rel_k_i.to(torch.float32)
    n_pos = torch.where(is_last, cum_rel, 0.0)

    if metric == "average_precision":
        contrib = binary_t * cum_rel_k / rank
        if in_k is not None:
            contrib = torch.where(in_k, contrib, 0.0)
        cum_contrib = _segment_cumsum_float(contrib, new_seg)  # float stream: block-local
        scores = torch.where(is_last & (cum_rel_k > 0), cum_contrib / cum_rel_k.clamp_min(1.0), 0.0)
        return scores, n_pos, valid

    if metric == "reciprocal_rank":
        seg_start_row = pos - rank + 1
        first_rel_rank = (a_out[2] - 1 - seg_start_row + 1).to(torch.float32)
        scores = torch.where(is_last & (n_pos > 0), 1.0 / first_rel_rank.clamp_min(1.0), 0.0)
        return scores, n_pos, valid

    if metric == "ndcg":
        # DCG over score-ranked targets, IDCG over value-sorted targets: both layouts
        # are query-major with equal segment spans, so rank, in_k and disc carry over
        disc = 1.0 / torch.log2(rank.to(torch.float32) + 1.0)

        def dcg_terms(t: Tensor) -> Tensor:
            terms = t * disc
            return terms if in_k is None else torch.where(in_k, terms, 0.0)

        cum_dcg = _segment_cumsum_float(dcg_terms(s_target.to(torch.float32)), new_seg)
        # the ideal layout's targets come back from the sorted key itself
        if target.is_floating_point():
            _, key2, _ = _sort_by_query(indexes, descending_sort_key(target))
            s_t2 = _sortable_key_to_f32(key2)
        else:
            _, key2, _ = _sort_by_query(indexes, -target.to(torch.int32))
            s_t2 = (-key2).to(torch.float32)
        cum_idcg = _segment_cumsum_float(dcg_terms(s_t2), new_seg)
        idcg = torch.where(is_last, cum_idcg, 0.0)
        scores = torch.where(is_last & (idcg > 0), (cum_dcg / idcg.clamp_min(1e-12)).clamp(0.0, 1.0), 0.0)
        return scores, n_pos, valid

    if metric == "r_precision":
        # the query's positive total reaches every row as prefix + suffix - value (one
        # reverse pass over segment-last flags); the re-count gated on it is a third pass
        (suffix,) = segment_multi_scan((binary_i,), is_last, reverse=True)
        total = (cum_rel_i + suffix - binary_i).to(torch.float32)
        in_r = (rank.to(torch.float32) <= total).to(torch.int32)
        (rel_in_r_i,) = segment_multi_scan((binary_i * in_r,), new_seg)
        scores = torch.where(is_last & (n_pos > 0), rel_in_r_i.to(torch.float32) / n_pos.clamp_min(1.0), 0.0)
        return scores, n_pos, valid

    count_f = rank.to(torch.float32)  # at the last row: the segment's size
    if top_k is None:
        k_per_seg = count_f
    elif adaptive_k:
        k_per_seg = count_f.clamp_max(float(top_k))
    else:
        k_per_seg = torch.full_like(count_f, float(top_k))

    if metric == "precision":
        scores = torch.where(is_last & (n_pos > 0), cum_rel_k / k_per_seg.clamp_min(1.0), 0.0)
        return scores, n_pos, valid
    if metric == "recall":
        scores = torch.where(is_last & (n_pos > 0), cum_rel_k / n_pos.clamp_min(1.0), 0.0)
        return scores, n_pos, valid
    if metric == "hit_rate":
        scores = torch.where(is_last & (cum_rel_k > 0), 1.0, 0.0)
        return scores, n_pos, valid
    raise ValueError(f"Metric {metric} is not scan-friendly")


def grouped_retrieval_scores(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    metric: str,
    top_k: Optional[int] = None,
    adaptive_k: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-query ``(scores, n_positive, valid)`` of every query, each of length N.

    ROW-ALIGNED: a query's values sit at its LAST row in (query, descending score)
    order; every other row holds 0 / False. Consume them position-agnostically
    (masked reductions over ``valid``), never as a prefix. ``n_positive`` counts the
    query's positive targets (negatives for ``fall_out``), for the caller's
    ``empty_target_action``. Rows with a negative index (``CatBuffer`` fill) form no
    valid query.
    """
    if metric not in _SCAN_METRICS:
        raise ValueError(f"Unknown grouped retrieval metric: {metric}")
    return _scan_retrieval_scores(indexes, preds, target, metric, top_k, adaptive_k)
