"""SSIM and MS-SSIM (counterpart of ``metrics_tpu/functional/image/ssim.py``).

One blur over the stack ``cat(p, t, p*p, t*t, p*t)`` gives the five local moments;
the blur is a grouped ``F.conv2d`` (``F.conv3d`` for volumes) along each axis of the
separable window (:mod:`.helper`). Reflection padding, cropping and every argument
follow the JAX package.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import (
    _avg_pool,
    _gaussian,
    _reflection_pad_2d,
    _reflection_pad_3d,
    _separable_blur_2d,
    _separable_blur_3d,
)
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.distributed import reduce


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if len(preds.shape) not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got preds: {tuple(preds.shape)}."
        )
    return preds.to(torch.float32), target.to(torch.float32)


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM, and the full SSIM map or the contrast sensitivity when asked."""
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]
    kernel_size = list(kernel_size)
    sigma = list(sigma)

    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(f"`kernel_size` has dimension {len(kernel_size)}, expected {preds.ndim - 2}")
    if len(sigma) != preds.ndim - 2 or len(sigma) not in (2, 3):
        raise ValueError(f"`sigma` has dimension {len(sigma)}, expected {preds.ndim - 2}")
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    dtype, device = preds.dtype, preds.device
    if gaussian_kernel:
        gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
        pad_h = (gauss_kernel_size[0] - 1) // 2
        pad_w = (gauss_kernel_size[1] - 1) // 2
    else:
        pad_h = (kernel_size[0] - 1) // 2
        pad_w = (kernel_size[1] - 1) // 2

    if is_3d:
        pad_d = (gauss_kernel_size[2] - 1) // 2 if gaussian_kernel else (kernel_size[2] - 1) // 2
        preds = _reflection_pad_3d(preds, pad_d, pad_w, pad_h)
        target = _reflection_pad_3d(target, pad_d, pad_w, pad_h)
    else:
        preds = _reflection_pad_2d(preds, pad_h, pad_w)
        target = _reflection_pad_2d(target, pad_h, pad_w)
    if gaussian_kernel:
        windows = [_gaussian(k, s, dtype, device)[0] for k, s in zip(gauss_kernel_size, sigma)]
    else:
        windows = [torch.ones((k,), dtype=dtype, device=device) / k for k in kernel_size]

    input_list = torch.cat((preds, target, preds * preds, target * target, preds * target))
    outputs = _separable_blur_3d(input_list, windows) if is_3d else _separable_blur_2d(input_list, *windows)
    b = preds.shape[0]
    output_list = [outputs[i * b : (i + 1) * b] for i in range(5)]

    mu_pred_sq = output_list[0] ** 2
    mu_target_sq = output_list[1] ** 2
    mu_pred_target = output_list[0] * output_list[1]

    sigma_pred_sq = output_list[2] - mu_pred_sq
    sigma_target_sq = output_list[3] - mu_target_sq
    sigma_pred_target = output_list[4] - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    if is_3d:
        ssim_idx = ssim_idx_full_image[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d]
    else:
        ssim_idx = ssim_idx_full_image[..., pad_h:-pad_h, pad_w:-pad_w]

    if return_contrast_sensitivity:
        contrast_sensitivity = upper / lower
        if is_3d:
            contrast_sensitivity = contrast_sensitivity[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d]
        else:
            contrast_sensitivity = contrast_sensitivity[..., pad_h:-pad_h, pad_w:-pad_w]
        return ssim_idx.reshape(b, -1).mean(-1), contrast_sensitivity.reshape(b, -1).mean(-1)

    if return_full_image:
        return ssim_idx.reshape(b, -1).mean(-1), ssim_idx_full_image

    return ssim_idx.reshape(b, -1).mean(-1)


def _ssim_compute(similarities: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    return reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds,
    target,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
    device=None,
):
    """SSIM of image batches (B, C, H, W) or volumes (B, C, D, H, W)."""
    preds = to_tensor(preds, device)
    preds, target = _ssim_check_inputs(preds, to_tensor(target, preds.device))
    sim = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(sim, tuple):
        return _ssim_compute(sim[0], reduction), sim[1]
    return _ssim_compute(sim, reduction)


def _get_normalized_sim_and_cs(
    preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=None
):
    sim, contrast_sensitivity = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_contrast_sensitivity=True,
    )
    if normalize == "relu":
        sim = torch.clamp(sim, min=0.0)
        contrast_sensitivity = torch.clamp(contrast_sensitivity, min=0.0)
    return sim, contrast_sensitivity


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """MS-SSIM per image: the contrast sensitivity of each scale but the last, and the
    SSIM of the last, weighted by ``betas`` (each scale halves the image)."""
    mcs_list: List[Tensor] = []
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    sim = None
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=normalize
        )
        mcs_list.append(contrast_sensitivity)
        window = (2, 2, 2) if is_3d else (2, 2)
        preds = _avg_pool(preds, window)
        target = _avg_pool(target, window)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)

    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2

    # filled on the device, not copied from the host: a captured step may run this
    betas_arr = torch.stack([torch.full((), b, dtype=mcs_stack.dtype, device=mcs_stack.device) for b in betas])
    betas_arr = betas_arr.reshape(-1, 1)
    mcs_weighted = mcs_stack**betas_arr
    return torch.prod(mcs_weighted, dim=0)


def _multiscale_ssim_compute(mcs_per_image: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    return reduce(mcs_per_image, reduction)


def multiscale_structural_similarity_index_measure(
    preds,
    target,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
    device=None,
) -> Tensor:
    """MS-SSIM of image batches (B, C, H, W) or volumes (B, C, D, H, W)."""
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds = to_tensor(preds, device)
    preds, target = _ssim_check_inputs(preds, to_tensor(target, preds.device))
    mcs_per_image = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return _multiscale_ssim_compute(mcs_per_image, reduction)
