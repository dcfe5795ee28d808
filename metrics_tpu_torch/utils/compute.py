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
