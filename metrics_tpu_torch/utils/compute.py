"""Numeric helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""
from contextlib import contextmanager
from typing import Iterator

import numpy as np
import torch
from torch import Tensor


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """Elementwise ``num / denom`` with ``x / 0 -> 0``, in float32 unless an input is a wider float."""
    num = torch.as_tensor(num)
    denom = torch.as_tensor(denom, device=num.device)
    dtype = torch.promote_types(torch.promote_types(num.dtype, denom.dtype), torch.float32)
    if not dtype.is_floating_point:
        dtype = torch.float32
    num = num.to(dtype)
    denom = denom.to(dtype)
    zero = denom == 0
    return torch.where(zero, torch.zeros((), dtype=dtype, device=num.device), num / torch.where(zero, 1, denom))


@contextmanager
def fp32_exact() -> Iterator[None]:
    """Run float32 convolutions and matmuls in full float32 inside the block.

    cuDNN convolutions may use TF32 by default (``torch.backends.cudnn.allow_tf32``),
    which moves a deep network's features by about 1e-3 relative; the image metrics
    and the Inception forward choose float32 per call with this block instead of
    inheriting the global flags, which it restores on exit.
    """
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _safe_matmul(x: Tensor, y: Tensor) -> Tensor:
    """``x @ y.T``."""
    return torch.matmul(x, y.T)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under (x, y); ``direction`` flips the sign for descending x."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    mean_y = (y.narrow(axis, 0, n - 1) + y.narrow(axis, 1, n - 1)) / 2.0
    return (dx * mean_y).sum(dim=axis) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False, axis: int = -1) -> Tensor:
    """AUC with optional reordering by x; the direction follows x's monotonicity.

    As in the JAX package, unsorted x with ``reorder=False`` follows the sign of the
    steps (no raise): pass ``reorder=True`` for unsorted inputs.
    """
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y, device=x.device).to(torch.float32)
    if reorder:
        order = torch.argsort(x, dim=axis, stable=True)
        x = torch.take_along_dim(x, order, dim=axis)
        y = torch.take_along_dim(y, order, dim=axis)
        direction = torch.ones((), device=x.device)
    else:
        dx = torch.diff(x, dim=axis)
        direction = torch.where(torch.all(dx <= 0), -1.0, 1.0).to(x.device)
    return _auc_compute_without_check(x, y, direction, axis=axis)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the curve of 1-D ``x`` and ``y`` by the trapezoidal rule."""
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError(f"Expected 1d arrays, got x.ndim={x.ndim}, y.ndim={y.ndim}")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have the same length")
    return _auc_compute(x, y, reorder=reorder)


def _smallest_f32_at_least(value: float) -> np.float32:
    """The smallest float32 >= ``value`` (a float64 constant).

    Every curve value lies on the float32 grid, so ``v >= value`` compared in float64
    decides as the float32 compare against this cutoff (``np.float32(0.7)`` rounds
    down and would admit values below 0.7).
    """
    cutoff = np.float32(value)
    if float(cutoff) < value:
        cutoff = np.nextafter(cutoff, np.float32(np.inf), dtype=np.float32)
    return cutoff
