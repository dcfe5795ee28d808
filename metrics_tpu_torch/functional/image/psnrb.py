"""PSNR with the blocking effect factor (counterpart of ``metrics_tpu/functional/image/psnrb.py``).

The block-boundary and interior column and row indices depend on the image shape
and block size only; they are made on the device with ``torch.arange`` (a copy from
the host would synchronise, which a captured step refuses).
"""
import math
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking effect factor of a grayscale NCHW batch (summed over the batch)."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")

    def boundaries(size: int) -> Tuple[Tensor, Tensor]:
        """The block-boundary positions ``[block_size - 1, size - 1)`` in steps of
        ``block_size``, and the other positions of ``[0, size - 1)`` in order, made on
        the device (a host-to-device copy would synchronise)."""
        on = torch.arange(block_size - 1, max(size - 1, block_size - 1), block_size, device=x.device)
        n_off = max(size - 1, 0) - on.numel()
        j = torch.arange(n_off, device=x.device)
        # skip every block_size-th position: the j-th other one is j + j // (block_size - 1)
        off = j + j // (block_size - 1) if block_size > 1 else j
        return on, off

    h_b, h_bc = boundaries(width)
    v_b, v_bc = boundaries(height)

    d_b = torch.sum((x[:, :, :, h_b] - x[:, :, :, h_b + 1]) ** 2)
    d_bc = torch.sum((x[:, :, :, h_bc] - x[:, :, :, h_bc + 1]) ** 2)
    d_b = d_b + torch.sum((x[:, :, v_b, :] - x[:, :, v_b + 1, :]) ** 2)
    d_bc = d_bc + torch.sum((x[:, :, v_bc, :] - x[:, :, v_bc + 1, :]) ** 2)

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), 0.0)


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    sum_squared_error = torch.sum((preds - target) ** 2)
    n_obs = torch.full((), target.numel(), device=target.device)
    bef = _compute_bef(preds, block_size=block_size)
    return sum_squared_error, bef, n_obs


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, n_obs: Tensor, data_range: Tensor) -> Tensor:
    mse = sum_squared_error / n_obs + bef
    peak = torch.where(data_range > 2, data_range.to(torch.float32) ** 2, 1.0)
    return 10 * torch.log10(peak / mse)


def peak_signal_noise_ratio_with_blocked_effect(preds, target, block_size: int = 8, device=None) -> Tensor:
    """PSNR penalised by the blocking effect factor (grayscale NCHW input)."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_squared_error, bef, n_obs = _psnrb_update(preds, target, block_size=block_size)
    data_range = target.max() - target.min()
    return _psnrb_compute(sum_squared_error, bef, n_obs, data_range)
