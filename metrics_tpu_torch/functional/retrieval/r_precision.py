"""Retrieval R-precision functional (counterpart of ``metrics_tpu/functional/retrieval/r_precision.py``)."""

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_r_precision(preds, target, device=None) -> Tensor:
    """R-precision of a single query: the relevant share of its top R, R its number
    of relevant documents."""
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    n_rel = (target > 0).sum()
    t = (ranked_targets(preds, target) > 0).to(torch.float32)
    rank = torch.arange(1, preds.shape[-1] + 1, device=t.device)
    rel_in_r = torch.where(rank <= n_rel, t, 0.0).sum()
    return torch.where(n_rel > 0, rel_in_r / n_rel.to(torch.float32).clamp_min(1.0), 0.0)
