"""MSLE (counterpart of ``metrics_tpu/functional/regression/log_mse.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    return torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds, target, device=None) -> Tensor:
    """Mean squared log error."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
