"""Spectral distortion index (counterpart of ``metrics_tpu/functional/image/d_lambda.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def spectral_distortion_index(
    preds, target, p: int = 1, reduction: Optional[str] = "elementwise_mean", device=None
) -> Tensor:
    """D_lambda: the distortion between the band-to-band UQI matrices of the fused and
    the low-resolution multispectral images (off-diagonal mean of ``|m1 - m2|^p``)."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    length = preds.shape[1]

    m1 = torch.zeros((length, length), device=preds.device)
    m2 = torch.zeros((length, length), device=preds.device)
    for k in range(length):
        for r in range(k, length):
            m1[k, r] = m1[r, k] = universal_image_quality_index(target[:, k : k + 1], target[:, r : r + 1])
            m2[k, r] = m2[r, k] = universal_image_quality_index(preds[:, k : k + 1], preds[:, r : r + 1])

    diff = torch.abs(m1 - m2) ** p
    mask = 1.0 - torch.eye(length, device=preds.device)
    output = (diff * mask).sum() / (length * (length - 1))
    return output ** (1.0 / p)
