"""MAE (counterpart of ``metrics_tpu/functional/regression/mae.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    return torch.sum(torch.abs(preds - target)), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds, target, device=None) -> Tensor:
    """Mean absolute error."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
