"""Retrieval MRR functional (counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``)."""

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_reciprocal_rank(preds, target, device=None) -> Tensor:
    """Reciprocal rank of the first relevant document of a single query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.retrieval import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> retrieval_reciprocal_rank(preds, target)
        tensor(0.5000)
    """
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    t = ranked_targets(preds, target) > 0
    rank = torch.arange(1, preds.shape[-1] + 1, device=t.device)
    first = torch.where(t, rank, preds.shape[-1] + 1).min()
    return torch.where(t.any(), 1.0 / first.to(torch.float32), 0.0)
