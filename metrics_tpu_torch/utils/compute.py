"""Numeric helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""
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
