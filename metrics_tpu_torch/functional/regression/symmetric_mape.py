"""SMAPE (counterpart of ``metrics_tpu/functional/regression/symmetric_mape.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return 2 * torch.sum(abs_per_error), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs) -> Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds, target, device=None) -> Tensor:
    """Symmetric mean absolute percentage error."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
