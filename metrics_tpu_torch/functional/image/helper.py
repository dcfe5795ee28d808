"""Image window helpers (counterpart of ``metrics_tpu/functional/image/helper.py``).

The gaussian and uniform windows are separable, and the blur of SSIM, UQI and the
sliding-window metrics is a grouped (depthwise) ``F.conv2d`` along each axis in turn
(``F.conv3d`` for volumes), in full float32 (TF32 off, see
:func:`~metrics_tpu_torch.utils.compute.fp32_exact`). The JAX package's banded-matmul
blur exists because XLA lowers float32 depthwise convolutions on the TPU through
several bfloat16 passes; cuDNN has no such limit. One pass per axis sums k terms a
pixel where the product window sums k^2 (k^3 in 3-D): fewer operations, and less
rounding (on an SSIM map of 2x2x12x14x16 volumes, 2.4e-6 from float64 against 1.2e-5
for the product window).
"""
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.compute import fp32_exact


def _gaussian(kernel_size: int, sigma: float, dtype=torch.float32, device=None) -> Tensor:
    """1-D gaussian window, normalised, as a ``(1, kernel_size)`` row."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return (gauss / gauss.sum())[None, :]


def _separable_blur_2d(x: Tensor, g_h: Tensor, g_w: Tensor) -> Tensor:
    """VALID blur of ``x`` (N, C, Hp, Wp) by the separable window ``g_h`` x ``g_w``: a
    grouped conv along the width, then one along the height (the JAX package's order)."""
    c = x.shape[1]
    x = _depthwise_conv2d(x, g_w.to(x.dtype).reshape(1, 1, 1, -1).expand(c, 1, 1, g_w.shape[0]))
    return _depthwise_conv2d(x, g_h.to(x.dtype).reshape(1, 1, -1, 1).expand(c, 1, g_h.shape[0], 1))


def _separable_blur_3d(x: Tensor, windows: Sequence[Tensor]) -> Tensor:
    """VALID blur of ``x`` (N, C, D, H, W) by the separable window whose factors along
    dims 2, 3 and 4 are ``windows``: one grouped conv per dim."""
    c = x.shape[1]
    for axis, g in enumerate(windows):
        shape = [1, 1, 1]
        shape[axis] = g.shape[0]
        x = _depthwise_conv3d(x, g.to(x.dtype).reshape(1, 1, *shape).expand(c, 1, *shape))
    return x


def _depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """Grouped (per-channel) VALID conv: x (N, C, H, W), kernel (C, 1, kh, kw)."""
    with fp32_exact():
        return F.conv2d(x, kernel, groups=x.shape[1])


def _depthwise_conv3d(x: Tensor, kernel: Tensor) -> Tensor:
    """Grouped (per-channel) VALID conv: x (N, C, D, H, W), kernel (C, 1, kd, kh, kw)."""
    with fp32_exact():
        return F.conv3d(x, kernel, groups=x.shape[1])


def _reflection_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")


def _reflection_pad_3d(x: Tensor, pad_d: int, pad_w: int, pad_h: int) -> Tensor:
    """Pads dims 2, 3 and 4 by ``pad_h``, ``pad_w`` and ``pad_d``, in the JAX package's order."""
    return F.pad(x, (pad_d, pad_d, pad_w, pad_w, pad_h, pad_h), mode="reflect")


def _avg_pool(x: Tensor, window: Tuple[int, ...]) -> Tensor:
    """Average pooling with stride equal to the window."""
    return F.avg_pool2d(x, window) if len(window) == 2 else F.avg_pool3d(x, window)


def _symmetric_pad_2d(x: Tensor, left: int, right: int) -> Tensor:
    """numpy's ``symmetric`` pad (the edge row repeated) of the last two dims."""
    for dim in (-2, -1):
        size = x.shape[dim]
        x = torch.cat(
            [x.narrow(dim, 0, left).flip(dim), x, x.narrow(dim, size - right, right).flip(dim)], dim=dim
        )
    return x


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Same-size depthwise mean filter with symmetric padding."""
    left = window_size // 2
    right = window_size - 1 - left
    x = _symmetric_pad_2d(x, left, right)
    g = torch.ones((window_size,), dtype=x.dtype, device=x.device) / window_size
    return _separable_blur_2d(x, g, g)
