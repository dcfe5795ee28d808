"""Sliding-window RMSE (counterpart of ``metrics_tpu/functional/image/rmse_sw.py``)."""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _uniform_filter
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _rmse_sw_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_val_sum: Optional[Tensor],
    rmse_map: Optional[Tensor],
    total_images: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Add a batch's per-window RMSE map (summed over images) and its cropped mean."""
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    total_images = (total_images if total_images is not None else 0) + target.shape[0]
    error = (target - preds) ** 2
    error = _uniform_filter(error, window_size)
    _rmse_map = torch.sqrt(error)
    crop_slide = round(window_size / 2)

    val = _rmse_map[:, :, crop_slide:-crop_slide, crop_slide:-crop_slide].sum(0).mean()
    rmse_val_sum = (rmse_val_sum + val) if rmse_val_sum is not None else val
    rmse_map = (rmse_map + _rmse_map.sum(0)) if rmse_map is not None else _rmse_map.sum(0)
    return rmse_val_sum, rmse_map, torch.as_tensor(total_images, device=target.device)


def _rmse_sw_compute(
    rmse_val_sum: Optional[Tensor], rmse_map: Tensor, total_images: Tensor
) -> Tuple[Optional[Tensor], Tensor]:
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    rmse_map = rmse_map / total_images
    return rmse, rmse_map


def root_mean_squared_error_using_sliding_window(
    preds, target, window_size: int = 8, return_rmse_map: bool = False, device=None
) -> Union[Optional[Tensor], Tuple[Optional[Tensor], Tensor]]:
    """RMSE over sliding windows of a (B, C, H, W) batch, and its map when asked."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    preds = to_tensor(preds, device)
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, to_tensor(target, preds.device), window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse
