"""Explained variance (counterpart of ``metrics_tpu/functional/regression/explained_variance.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs, sum_error: Tensor, sum_squared_error: Tensor, sum_target: Tensor, sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg**2
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg**2

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    output_scores = torch.ones_like(diff_avg)
    output_scores = torch.where(
        valid_score, 1.0 - numerator / torch.where(valid_score, denominator, 1.0), output_scores
    )
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        return torch.sum(denominator / torch.sum(denominator) * output_scores)
    raise ValueError(f"Argument `multioutput` must be one of {ALLOWED_MULTIOUTPUT}, got {multioutput}")


def explained_variance(preds, target, multioutput: str = "uniform_average", device=None) -> Tensor:
    """Explained variance."""
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}")
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    n_obs, sum_error, ss_error, sum_target, ss_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(n_obs, sum_error, ss_error, sum_target, ss_target, multioutput)
