"""Retrieval AP functional (counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_average_precision(preds, target, top_k: Optional[int] = None, device=None) -> Tensor:
    """Average precision of a single query (at ``top_k`` when given).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.retrieval import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_average_precision(preds, target)
        tensor(0.8333)
    """
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    top_k = top_k or preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError(f"Argument ``top_k`` has to be a positive integer or None, but got {top_k}.")
    k = min(top_k, preds.shape[-1])
    t = (ranked_targets(preds, target)[:k] > 0).to(torch.float32)
    n_rel = t.sum()
    pos = torch.arange(1, k + 1, dtype=torch.float32, device=t.device)
    return torch.where(n_rel > 0, (t * torch.cumsum(t, 0) / pos).sum() / n_rel.clamp_min(1.0), 0.0)
