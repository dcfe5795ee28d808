"""Spearman correlation (counterpart of ``metrics_tpu/functional/regression/spearman.py``).

Ranks come from :func:`~metrics_tpu_torch.ops.rank.average_ranks` for the predictions'
and the targets' columns together: one sort and two segmented-scan launches on the
card per compute, whatever the number of outputs (the JAX package ranks one column
at a time, :44-50). Ranks are exact (float64; the JAX package's float32 rank sums are
exact while they stay below 2^24), and the correlation is taken in float64 and
returned as float32.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.pearson import _check_data_shape_to_num_outputs
from metrics_tpu_torch.ops.rank import average_ranks
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _spearman_corrcoef_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {str(preds.dtype).replace('torch.', '')} and {str(target.dtype).replace('torch.', '')}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds.to(torch.float32), target.to(torch.float32)


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    one_d = preds.dim() == 1
    p = preds[:, None] if one_d else preds
    t = target[:, None] if one_d else target
    ranks = average_ranks(torch.cat([p, t], dim=1))
    c = p.shape[1]
    preds_diff = ranks[:, :c] - ranks[:, :c].mean(0)
    target_diff = ranks[:, c:] - ranks[:, c:].mean(0)
    cov = (preds_diff * target_diff).mean(0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(0))
    target_std = torch.sqrt((target_diff * target_diff).mean(0))
    corrcoef = torch.clamp(cov / (preds_std * target_std + eps), -1.0, 1.0).to(torch.float32)
    return corrcoef[0] if one_d else corrcoef


def spearman_corrcoef(preds, target, device=None) -> Tensor:
    """Spearman rank correlation."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs=1 if preds.dim() == 1 else preds.shape[-1])
    return _spearman_corrcoef_compute(preds, target)
