"""R2 score (counterpart of ``metrics_tpu/functional/regression/r2.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.dim() > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: Tensor, sum_obs: Tensor, rss: Tensor, n_obs, adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    """R2 with the JAX package's handling of near-constant targets."""
    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs

    cond_rss = rss < 1e-4 * torch.abs(sum_squared_obs)
    cond = (tss < 1e-4 * torch.abs(sum_squared_obs)) & cond_rss
    raw_scores = torch.where(cond, 1.0, 1 - rss / torch.where(tss != 0, tss, 1.0))
    raw_scores = torch.where(~cond & (tss == 0), 0.0, raw_scores)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = torch.sum(tss / torch.sum(tss) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        n_obs = int(n_obs)
        if adjusted > n_obs - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n_obs - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(preds, target, adjusted: int = 0, multioutput: str = "uniform_average", device=None) -> Tensor:
    """R2 score."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    if n_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
