"""KL divergence (counterpart of ``metrics_tpu/functional/regression/kl_divergence.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_xlogy
from metrics_tpu_torch.utils.data import to_tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    if p.dim() != 2 or q.dim() != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.dim()} and {q.dim()} respectively")
    p, q = p.to(torch.float32), q.to(torch.float32)
    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / p.sum(dim=-1, keepdim=True)
        q = q / q.sum(dim=-1, keepdim=True)
        measures = _safe_xlogy(p, p / q).sum(dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(p, q, log_prob: bool = False, reduction: Optional[str] = "mean", device=None) -> Tensor:
    """KL divergence D(p||q) per sample, with reduction."""
    p = to_tensor(p, device)
    q = to_tensor(q, p.device)
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
