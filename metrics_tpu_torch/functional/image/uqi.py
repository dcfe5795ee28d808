"""Universal image quality index (counterpart of ``metrics_tpu/functional/image/uqi.py``).

UQI is SSIM without the stabilising constants (c1 = c2 = 0), on a gaussian window.
"""
from typing import Optional, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.helper import _gaussian, _reflection_pad_2d, _separable_blur_2d
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.distributed import reduce


def universal_image_quality_index(
    preds,
    target,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    device=None,
) -> Tensor:
    """UQI map of a (B, C, H, W) batch, reduced by ``reduction``."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if not isinstance(kernel_size, Sequence) or len(kernel_size) != 2:
        raise ValueError(f"Expected `kernel_size` to be a sequence of length 2. Got {kernel_size}.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)

    g_h = _gaussian(kernel_size[0], sigma[0], device=preds.device)[0]
    g_w = _gaussian(kernel_size[1], sigma[1], device=preds.device)[0]
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    preds = _reflection_pad_2d(preds, pad_h, pad_w)
    target = _reflection_pad_2d(target, pad_h, pad_w)

    input_list = torch.cat((preds, target, preds * preds, target * target, preds * target))
    outputs = _separable_blur_2d(input_list, g_h, g_w)
    b = preds.shape[0]
    output_list = [outputs[i * b : (i + 1) * b] for i in range(5)]

    mu_pred_sq = output_list[0] ** 2
    mu_target_sq = output_list[1] ** 2
    mu_pred_target = output_list[0] * output_list[1]

    sigma_pred_sq = output_list[2] - mu_pred_sq
    sigma_target_sq = output_list[3] - mu_target_sq
    sigma_pred_target = output_list[4] - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(torch.float32).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return reduce(uqi_idx, reduction)
