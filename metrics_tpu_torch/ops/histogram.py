"""Static-length histograms with drop semantics: the confusion-matrix hot path.

Counterpart of ``metrics_tpu/ops/histogram.py``. There the Pallas kernel
``_histogram_kernel`` serves TPU inputs with up to 2048 bins and at least 2^18 ids,
and plain-XLA tiers (compare-reduce, the one-hot pair-split matmul, a scatter) cover
the rest. Here there are three paths, chosen by where the ids lie and how many bins
there are:

- **CPU tensor:** :func:`_plain_bincount`, a scatter-add into an overflow bin that is
  cut off. It is also the kernel's reference in the tests and in ``chip_smoke.py``.
- **CUDA tensor, ``num_bins <= KERNEL_MAX_BINS`` (2^14):** the hand-written kernel in
  ``csrc/histogram.cu`` through :func:`histogram_cuda`, at every N. This range also
  covers the TPU-only ``_pairsplit_bincount`` and ``ops/confmat.py:_confmat_matmul``
  tiers of the JAX package.
- **CUDA tensor, more bins:** the same scatter-add as the plain version, the
  counterpart of the JAX package's scatter fallback (``utils/data.py:205-207``).

There is no fallback from the kernel to another path: a CUDA tensor that the kernel
does not take raises.

Under a ``torch.func`` transform (the fleet's per-row ``vmap``) the histogram goes
through the custom op ``metrics_tpu_torch::bincount``, whose batching rule is the
counterpart of the Pallas kernel's batching rule (one more grid axis): ids ``(B, k)``
give one ``(B, num_bins)`` histogram per row, counted in one launch of the kernel's
batched mode (``tm_histogram_batched``, :class:`BatchedHistogramKernel`) on the
card, and by :func:`_plain_batched_bincount` on the CPU, at any bin count. A
ctypes launch cannot take a batched tensor; the op's rule hands it the plain
batch. Outside a transform the call goes to the paths above directly, without the
custom op's dispatch.

Every path drops ids outside ``[0, num_bins)``. Counts and bool/uint8-masked counts
are int32; float32 weights sum in float32.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build

KERNEL_MAX_BINS = 1 << 14
_MODE_COUNT, _MODE_MASK, _MODE_WEIGHT = 0, 1, 2
_INT32_MAX = (1 << 31) - 1


def _out_dtype(weights: Optional[Tensor]) -> torch.dtype:
    if weights is None or weights.dtype in (torch.bool, torch.uint8):
        return torch.int32
    return weights.dtype


def _plain_bincount(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    """Plain PyTorch histogram with drop semantics (any device, any weight dtype).

    Dropped ids go to an extra bin ``num_bins`` that is cut off at the end.
    """
    x = x.reshape(-1)
    keep = (x >= 0) & (x < num_bins)
    idx = torch.where(keep, x.to(torch.int64), num_bins)
    dtype = _out_dtype(weights)
    if weights is None:
        values = torch.ones_like(idx, dtype=dtype)
    else:
        values = weights.reshape(-1).to(dtype)
    out = torch.zeros(num_bins + 1, dtype=dtype, device=x.device)
    out.index_add_(0, idx, values)
    return out[:num_bins]


class HistogramKernel:
    """Wrapper of the CUDA histogram kernel: checks, launch, and a count of launches.

    ``launches`` grows by one each time the kernel is launched, and nowhere else: a
    call inside a CUDA-graph capture only records the launch and is not counted; each
    replay of that graph counts it (``core/fused.py:CapturedStep``).
    """

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = _build.load("histogram").tm_histogram
        return self._fn

    def __call__(self, ids: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
        """Histogram of int32 CUDA ``ids`` over ``[0, num_bins)``.

        ``weights`` is None (count), a bool/uint8 mask (masked count) or float32; the
        output is int32, int32 or float32. All tensors are 1-D, contiguous and on the
        same CUDA device.
        """
        if ids.device.type != "cuda":
            raise ValueError(f"histogram kernel: ids must be a CUDA tensor, got one on {ids.device}")
        if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
            raise ValueError(
                f"histogram kernel: ids must be 1-D contiguous int32, got {ids.dtype} of shape {tuple(ids.shape)}"
            )
        if not 1 <= num_bins <= KERNEL_MAX_BINS:
            raise ValueError(f"histogram kernel: num_bins must lie in [1, {KERNEL_MAX_BINS}], got {num_bins}")
        if ids.numel() > _INT32_MAX:
            raise ValueError(f"histogram kernel: at most 2^31 - 1 ids per call, got {ids.numel()}")
        if weights is None:
            mode = _MODE_COUNT
        else:
            if weights.device != ids.device:
                raise ValueError(f"histogram kernel: weights on {weights.device}, ids on {ids.device}")
            if weights.dim() != 1 or not weights.is_contiguous() or weights.shape != ids.shape:
                raise ValueError("histogram kernel: weights must be 1-D, contiguous and of the ids' length")
            if weights.dtype in (torch.bool, torch.uint8):
                mode = _MODE_MASK
            elif weights.dtype == torch.float32:
                mode = _MODE_WEIGHT
            else:
                raise TypeError(f"histogram kernel: weights must be bool, uint8 or float32, got {weights.dtype}")
        if ids.numel() == 0:
            return torch.zeros(num_bins, dtype=_out_dtype(weights), device=ids.device)
        out = torch.empty(num_bins, dtype=_out_dtype(weights), device=ids.device)  # the kernel zeroes it
        fn = self._function()
        weight_ptr = None if weights is None else weights.data_ptr()
        err = _build.call_on_device(
            ids.device,
            lambda stream: fn(ids.data_ptr(), weight_ptr, mode, ids.numel(), num_bins, out.data_ptr(), stream),
        )
        if err != 0:
            raise RuntimeError(f"histogram kernel launch failed with CUDA error {err}")
        _build.note_launch(self)
        return out


histogram_cuda = HistogramKernel()


def _plain_batched_bincount(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    """Plain PyTorch version of the batched mode: ``(B, k)`` ids give ``(B, num_bins)``
    histograms, one per row, with drop semantics (any device, any weight dtype).

    Each row's ids are offset by ``row * num_bins`` into one histogram of
    ``B * num_bins`` bins; a dropped id stays out of range.
    """
    rows = x.shape[0]
    keep = (x >= 0) & (x < num_bins)
    offsets = torch.arange(rows, device=x.device, dtype=torch.int64).unsqueeze(1) * num_bins
    ids = torch.where(keep, x.to(torch.int64) + offsets, -1)
    return _plain_bincount(ids, weights, rows * num_bins).reshape(rows, num_bins)


class BatchedHistogramKernel:
    """Wrapper of the kernel's batched mode (``tm_histogram_batched``): checks, launch,
    and a count of launches.

    ``launches`` grows by one each time the kernel is launched, and nowhere else: a
    call inside a CUDA-graph capture only records the launch and is not counted; each
    replay of that graph counts it (``core/fused.py:CapturedStep``).
    """

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = _build.load("histogram").tm_histogram_batched
        return self._fn

    def __call__(self, ids: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
        """Histograms of the rows of int32 CUDA ``ids`` ``(B, k)`` over ``[0, num_bins)``:
        ``(B, num_bins)``, int32 for counts and bool/uint8 masks, float32 for float32
        weights of the ids' shape. ``B * num_bins`` may exceed the single-histogram
        kernel's 2^14 bins (at most 2^31 - 1)."""
        if ids.device.type != "cuda":
            raise ValueError(f"batched histogram kernel: ids must be a CUDA tensor, got one on {ids.device}")
        if ids.dtype != torch.int32 or ids.dim() != 2 or not ids.is_contiguous():
            raise ValueError(
                "batched histogram kernel: ids must be 2-D contiguous int32, got"
                f" {ids.dtype} of shape {tuple(ids.shape)}"
            )
        rows, row_len = ids.shape
        if num_bins < 1 or rows * num_bins > _INT32_MAX or ids.numel() > _INT32_MAX:
            raise ValueError(
                f"batched histogram kernel: {rows} rows of {num_bins} bins and {ids.numel()} ids"
                " must each stay within 2^31 - 1"
            )
        if weights is None:
            mode = _MODE_COUNT
        else:
            if weights.device != ids.device or weights.shape != ids.shape or not weights.is_contiguous():
                raise ValueError("batched histogram kernel: weights must be contiguous, of the ids' shape and device")
            if weights.dtype in (torch.bool, torch.uint8):
                mode = _MODE_MASK
            elif weights.dtype == torch.float32:
                mode = _MODE_WEIGHT
            else:
                raise TypeError(
                    f"batched histogram kernel: weights must be bool, uint8 or float32, got {weights.dtype}"
                )
        if ids.numel() == 0:
            return torch.zeros((rows, num_bins), dtype=_out_dtype(weights), device=ids.device)
        out = torch.empty((rows, num_bins), dtype=_out_dtype(weights), device=ids.device)  # the kernel zeroes it
        fn = self._function()
        weight_ptr = None if weights is None else weights.data_ptr()
        err = _build.call_on_device(
            ids.device,
            lambda stream: fn(
                ids.data_ptr(), weight_ptr, mode, ids.numel(), row_len, rows, num_bins, out.data_ptr(), stream
            ),
        )
        if err != 0:
            raise RuntimeError(f"batched histogram kernel launch failed with CUDA error {err}")
        _build.note_launch(self)
        return out


histogram_batched_cuda = BatchedHistogramKernel()


def _batched_dispatch(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    """``(B, k)`` ids -> ``(B, num_bins)``: the batched kernel for CUDA ids, the plain
    version for CPU ids."""
    if weights is not None and weights.device != x.device:
        raise ValueError(f"bincount: weights on {weights.device}, ids on {x.device}")
    if x.device.type != "cuda":
        return _plain_batched_bincount(x, weights, num_bins)
    if x.dtype != torch.int32:
        x = x.clamp(-1, num_bins).to(torch.int32)
    return histogram_batched_cuda(x.contiguous(), None if weights is None else weights.contiguous(), num_bins)


@torch.library.custom_op("metrics_tpu_torch::bincount", mutates_args=())
def _bincount_op(x: Tensor, weights: Optional[Tensor], num_bins: int, rows: int) -> Tensor:
    """The histogram as a custom op. ``rows == 0``: one histogram of the flat ids
    (:func:`_dispatch`). ``rows >= 1``: ``x`` holds ``rows`` equal runs of ids, and
    the result is their ``rows * num_bins`` histograms, flat (the batched mode)."""
    if rows == 0:
        return _dispatch_direct(x, weights, num_bins)
    x = x.reshape(rows, -1)
    weights = None if weights is None else weights.reshape(rows, -1)
    return _batched_dispatch(x, weights, num_bins).reshape(-1)


@_bincount_op.register_fake
def _bincount_fake(x: Tensor, weights: Optional[Tensor], num_bins: int, rows: int) -> Tensor:
    return x.new_empty((max(rows, 1) * num_bins,), dtype=_out_dtype(weights))


def _bincount_vmap(info, in_dims: Tuple, x: Tensor, weights: Optional[Tensor], num_bins: int, rows: int):
    """Batching rule: ``B`` calls of ``rows`` histograms are one call of ``B * rows``."""
    batch = info.batch_size
    x_dim, w_dim = in_dims[0], in_dims[1]
    x = x.movedim(x_dim, 0) if x_dim is not None else x.unsqueeze(0).expand(batch, *x.shape)
    if weights is not None:
        weights = (weights.movedim(w_dim, 0) if w_dim is not None
                   else weights.unsqueeze(0).expand(batch, *weights.shape)).reshape(-1)
    out = _bincount_op(x.reshape(-1), weights, num_bins, batch * max(rows, 1))
    return out.reshape(batch, -1), 0


torch.library.register_vmap("metrics_tpu_torch::bincount", _bincount_vmap)


def _dispatch(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    if torch._C._are_functorch_transforms_active() or _build.faking(x):
        return torch.ops.metrics_tpu_torch.bincount(
            x.reshape(-1), None if weights is None else weights.reshape(-1), num_bins, 0
        )
    return _dispatch_direct(x, weights, num_bins)


def _dispatch_direct(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    x = x.reshape(-1)
    if weights is not None:
        weights = weights.reshape(-1)
        if weights.device != x.device:
            raise ValueError(f"bincount: weights on {weights.device}, ids on {x.device}")
    if x.device.type == "cuda" and num_bins <= KERNEL_MAX_BINS:
        if weights is not None:
            weights = weights.contiguous()
        if x.dtype != torch.int32:
            # clamp first so that a wide id outside int32 cannot wrap into range
            x = x.clamp(-1, num_bins).to(torch.int32)
        return histogram_cuda(x.contiguous(), weights, num_bins)
    return _plain_bincount(x, weights, num_bins)


def bincount(x: Tensor, num_bins: int) -> Tensor:
    """Unweighted int32 histogram of ``x`` over ``[0, num_bins)`` with drop semantics."""
    return _dispatch(x, None, num_bins)


def bincount_weighted(x: Tensor, weights: Tensor, num_bins: int) -> Tensor:
    """Weighted histogram with drop semantics (int32 for a bool/uint8 mask)."""
    return _dispatch(x, weights, num_bins)


def bincount_batched(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
    """``(B, k)`` ids -> ``(B, num_bins)`` histograms, one per row, with drop semantics
    (int32 for counts and bool/uint8 masks): one launch of the kernel's batched mode on
    the card, through the custom op under a ``torch.func`` transform."""
    rows = x.shape[0]
    if x.numel() == 0:
        return torch.zeros((rows, num_bins), dtype=_out_dtype(weights), device=x.device)
    if torch._C._are_functorch_transforms_active() or _build.faking(x):
        flat_weights = None if weights is None else weights.reshape(-1)
        return torch.ops.metrics_tpu_torch.bincount(x.reshape(-1), flat_weights, num_bins, rows).reshape(rows, num_bins)
    return _batched_dispatch(x, weights, num_bins)
