"""RASE (counterpart of ``metrics_tpu/functional/image/rase.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _uniform_filter
from metrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update
from metrics_tpu_torch.utils.data import to_tensor


def _rase_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_map: Optional[Tensor],
    target_sum: Optional[Tensor],
    total_images: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Add a batch's RMSE map and windowed target sum; the ``/ window_size**2`` of the
    already averaged filter is the JAX package's (and its reference's) arithmetic."""
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    target = target.to(torch.float32)
    inc = torch.sum(_uniform_filter(target, window_size) / (window_size**2), dim=0)
    target_sum = target_sum + inc if target_sum is not None else inc
    return rmse_map, target_sum, total_images


def _rase_compute(rmse_map: Tensor, target_sum: Tensor, total_images: Tensor, window_size: int) -> Tensor:
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = target_sum / total_images
    target_mean = target_mean.mean(0)  # mean over channels
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop_slide = round(window_size / 2)
    return torch.mean(rase_map[crop_slide:-crop_slide, crop_slide:-crop_slide])


def relative_average_spectral_error(preds, target, window_size: int = 8, device=None) -> Tensor:
    """RASE of a (B, C, H, W) batch over sliding windows."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
    preds = to_tensor(preds, device)
    rmse_map, target_sum, total_images = _rase_update(
        preds, to_tensor(target, preds.device), window_size, rmse_map=None, target_sum=None, total_images=None
    )
    return _rase_compute(rmse_map, target_sum, total_images, window_size)
