"""Retrieval recall functional (counterpart of ``metrics_tpu/functional/retrieval/recall.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_recall(preds, target, top_k: Optional[int] = None, device=None) -> Tensor:
    """Recall@k of a single query."""
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    if top_k is None:
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    relevant = (ranked_targets(preds, target)[:top_k] > 0).sum().to(torch.float32)
    total = (target > 0).sum().to(torch.float32)
    return torch.where(total > 0, relevant / total.clamp_min(1.0), 0.0)
