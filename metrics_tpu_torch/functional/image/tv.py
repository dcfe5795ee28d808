"""Total variation (counterpart of ``metrics_tpu/functional/image/tv.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = torch.abs(diff1).sum((1, 2, 3))
    res2 = torch.abs(diff2).sum((1, 2, 3))
    return res1 + res2, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements, reduction: Optional[str]) -> Tensor:
    if reduction == "mean":
        return score.sum() / num_elements
    if reduction == "sum":
        return score.sum()
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img, reduction: Optional[str] = "sum", device=None) -> Tensor:
    """Total variation of a (B, C, H, W) batch, per image or reduced."""
    score, num_elements = _total_variation_update(to_tensor(img, device).to(torch.float32))
    return _total_variation_compute(score, num_elements, reduction)
