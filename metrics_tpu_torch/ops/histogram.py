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

Every path drops ids outside ``[0, num_bins)``. Counts and bool/uint8-masked counts
are int32; float32 weights sum in float32.
"""
from typing import Optional

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

    ``launches`` grows by one each time the kernel is launched, and nowhere else.
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
        self.launches += 1
        return out


histogram_cuda = HistogramKernel()


def _dispatch(x: Tensor, weights: Optional[Tensor], num_bins: int) -> Tensor:
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
