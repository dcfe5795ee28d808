"""Retrieval precision-recall curve functional (counterpart of ``metrics_tpu/functional/retrieval/precision_recall_curve.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_precision_recall_curve(
    preds, target, max_k: Optional[int] = None, adaptive_k: bool = False, device=None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision and recall of a single query at every cutoff k = 1..max_k.

    Args:
        preds: document relevance scores.
        target: binary relevance labels.
        max_k: largest cutoff (default: the number of documents).
        adaptive_k: cap the denominators at the document count when ``max_k``
            exceeds it.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.retrieval import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> precisions, recalls, top_k = retrieval_precision_recall_curve(preds, target, max_k=2)
        >>> precisions
        tensor([1.0000, 0.5000])
        >>> recalls
        tensor([0.5000, 0.5000])
    """
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    n_docs = preds.shape[-1]
    if max_k is None:
        max_k = n_docs
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")

    topk = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
    if adaptive_k and max_k > n_docs:
        topk = topk.clamp_max(n_docs)

    k_eff = min(max_k, n_docs)
    relevant = torch.zeros(max_k, dtype=torch.float32, device=preds.device)
    relevant[:k_eff] = ranked_targets(preds, target)[:k_eff].to(torch.float32)
    relevant = torch.cumsum(relevant, 0)

    n_pos = target.sum()
    recall = torch.where(n_pos > 0, relevant / n_pos.clamp_min(1), 0.0)
    precision = torch.where(n_pos > 0, relevant / topk, 0.0)
    return precision.to(torch.float32), recall.to(torch.float32), topk
