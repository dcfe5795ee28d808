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

The retrieval half of the JAX module (``_segment_cumsum_*``,
``_scan_retrieval_scores``, ``grouped_retrieval_scores``) comes with the retrieval
slice.
"""
import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build

_OP_CODES = {"sum": 0, "min": 1, "max": 2}  # the kernel's op codes
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

    ``launches`` grows by one each time the kernel is launched, and nowhere else.
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
        self.launches += 1
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
    if device.type != "cuda":
        return _plain_multi_scan(values, new_seg, ops, reverse)

    dtype = _kernel_dtype([v.dtype for v in values])
    flags = None if new_seg is None else new_seg.to(torch.bool).contiguous()
    outs = []
    for start in range(0, len(values), KERNEL_MAX_LANES):
        lanes = [v.to(dtype).contiguous() for v in values[start:start + KERNEL_MAX_LANES]]
        outs.extend(segment_scan_cuda(lanes, flags, ops[start:start + KERNEL_MAX_LANES], reverse))
    return tuple(o.to(v.dtype) for o, v in zip(outs, values))
