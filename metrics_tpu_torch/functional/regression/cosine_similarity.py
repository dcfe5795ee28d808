"""Cosine similarity (counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor

_REDUCTIONS = {"sum": torch.sum, "mean": torch.mean, "none": lambda x: x, None: lambda x: x}


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.norm(preds, dim=-1)
    target_norm = torch.linalg.norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    return _REDUCTIONS[reduction](similarity)


def cosine_similarity(preds, target, reduction: Optional[str] = "sum", device=None) -> Tensor:
    """Cosine similarity between rows of preds and target."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
