"""Retrieval hit-rate functional (counterpart of ``metrics_tpu/functional/retrieval/hit_rate.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_hit_rate(preds, target, top_k: Optional[int] = None, device=None) -> Tensor:
    """HitRate@k of a single query: 1 if a relevant document is in the top k."""
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    if top_k is None:
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    relevant = (ranked_targets(preds, target)[:top_k] > 0).sum()
    return (relevant > 0).to(torch.float32)
