"""Pearson correlation (counterpart of ``metrics_tpu/functional/regression/pearson.py``).

The running update is the Welford-style parallel merge, branchless as in the JAX
package (no host read of the prior count). ``PearsonCorrCoef``'s states reduce by
``None``: a sync stacks each process's moments, and ``regression/pearson.py``'s
``_final_aggregation`` merges the stack.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _check_data_shape_to_num_outputs(preds: Tensor, target: Tensor, num_outputs: int) -> None:
    if preds.dim() > 2 or target.dim() > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors,"
            f" but got {target.dim()} and {preds.dim()}."
        )
    # (N, 1) inputs count as single-output
    cond1 = num_outputs == 1 and not (preds.dim() == 1 or preds.shape[1] == 1)
    cond2 = num_outputs > 1 and num_outputs != preds.shape[-1]
    if cond1 or cond2:
        raise ValueError(
            f"Expected argument `num_outputs` to match the second dimension of input, but got {num_outputs}"
            f" and {preds.shape[-1] if preds.dim() > 1 else 1}."
        )


def _pearson_corrcoef_update(
    preds: Tensor, target: Tensor, mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor,
    corr_xy: Tensor, n_prior: Tensor, num_outputs: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Running moments after one more batch."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    cond = n_prior.mean() > 0
    n_obs = preds.shape[0]

    mx_new = torch.where(cond, (n_prior * mean_x + preds.sum(0)) / (n_prior + n_obs), preds.mean(0))
    my_new = torch.where(cond, (n_prior * mean_y + target.sum(0)) / (n_prior + n_obs), target.mean(0))
    n_prior = n_prior + n_obs

    var_x = var_x + torch.where(
        cond, ((preds - mx_new) * (preds - mean_x)).sum(0), preds.var(0, correction=1) * (n_obs - 1)
    )
    var_y = var_y + torch.where(
        cond, ((target - my_new) * (target - mean_y)).sum(0), target.var(0, correction=1) * (n_obs - 1)
    )
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(0)
    return mx_new, my_new, var_x, var_y, corr_xy, n_prior


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = torch.squeeze(corr_xy / torch.sqrt(var_x * var_y))
    return torch.clamp(corrcoef, -1.0, 1.0)


def _zero_moments(preds: Tensor) -> Tuple[Tensor, ...]:
    d = preds.shape[1] if preds.dim() == 2 else 1
    return tuple(torch.zeros(d, dtype=torch.float32, device=preds.device) for _ in range(6))


def pearson_corrcoef(preds, target, device=None) -> Tensor:
    """Pearson correlation coefficient."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    d = preds.shape[1] if preds.dim() == 2 else 1
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, *_zero_moments(preds), num_outputs=d)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
