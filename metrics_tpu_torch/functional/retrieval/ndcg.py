"""Retrieval NDCG functional (counterpart of ``metrics_tpu/functional/retrieval/ndcg.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def _dcg(target: Tensor) -> Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds, target, top_k: Optional[int] = None, device=None) -> Tensor:
    """NDCG@k of a single query (graded relevance allowed).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.retrieval import retrieval_normalized_dcg
        >>> preds = torch.tensor([.1, .2, .3, 4, 70.])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> retrieval_normalized_dcg(preds, target)
        tensor(0.6957)
    """
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(
        preds, to_tensor(target, preds.device), allow_non_binary_target=True
    )
    top_k = preds.shape[-1] if top_k is None else top_k
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    target = target.to(torch.float32)
    sorted_target = ranked_targets(preds, target)[:top_k]
    ideal_target = torch.sort(target, descending=True).values[:top_k]
    ideal_dcg = _dcg(ideal_target)
    score = torch.where(ideal_dcg > 0, _dcg(sorted_target) / ideal_dcg.clamp_min(1e-12), 0.0)
    return score.clamp(0.0, 1.0)
