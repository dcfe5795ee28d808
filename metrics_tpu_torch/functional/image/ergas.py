"""ERGAS (counterpart of ``metrics_tpu/functional/image/ergas.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.distributed import reduce


def _ergas_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    return preds.to(torch.float32), target.to(torch.float32)


def _ergas_compute(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds, target, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", device=None
) -> Tensor:
    """ERGAS of a (B, C, H, W) batch at resolution ``ratio``."""
    preds = to_tensor(preds, device)
    preds, target = _ergas_update(preds, to_tensor(target, preds.device))
    return _ergas_compute(preds, target, ratio, reduction)
