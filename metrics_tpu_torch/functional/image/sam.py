"""Spectral angle mapper (counterpart of ``metrics_tpu/functional/image/sam.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.distributed import reduce


def _sam_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[1] <= 1:
        raise ValueError(f"Expected channel dimension of `preds` and `target` to be larger than 1. Got {preds.shape[1]}.")
    return preds.to(torch.float32), target.to(torch.float32)


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.norm(preds, dim=1)
    target_norm = torch.linalg.norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1.0, 1.0))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds, target, reduction: Optional[str] = "elementwise_mean", device=None) -> Tensor:
    """Spectral angle (radians) between the pixels' channel vectors."""
    preds = to_tensor(preds, device)
    preds, target = _sam_update(preds, to_tensor(target, preds.device))
    return _sam_compute(preds, target, reduction)
