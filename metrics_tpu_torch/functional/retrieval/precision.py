"""Retrieval precision functional (counterpart of ``metrics_tpu/functional/retrieval/precision.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_precision(preds, target, top_k: Optional[int] = None, adaptive_k: bool = False, device=None) -> Tensor:
    """Precision@k of a single query; ``adaptive_k`` caps k at the document count."""
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if top_k is None or (adaptive_k and top_k > preds.shape[-1]):
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    relevant = (ranked_targets(preds, target)[: min(top_k, preds.shape[-1])] > 0).sum().to(torch.float32)
    return torch.where(target.sum() > 0, relevant / top_k, 0.0)
