"""Retrieval fall-out functional (counterpart of ``metrics_tpu/functional/retrieval/fall_out.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs
from metrics_tpu_torch.utils.data import to_tensor


def retrieval_fall_out(preds, target, top_k: Optional[int] = None, device=None) -> Tensor:
    """Fall-out@k of a single query: non-relevant retrieved over all non-relevant."""
    preds = to_tensor(preds, device)
    preds, target = _check_retrieval_functional_inputs(preds, to_tensor(target, preds.device))
    if top_k is None:
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    nonrel_in_k = (1 - (ranked_targets(preds, target)[:top_k] > 0).to(torch.int32)).sum().to(torch.float32)
    total_neg = (1 - (target > 0).to(torch.int32)).sum().to(torch.float32)
    return torch.where(total_neg > 0, nonrel_in_k / total_neg.clamp_min(1.0), 0.0)
