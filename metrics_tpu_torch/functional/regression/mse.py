"""MSE (counterpart of ``metrics_tpu/functional/regression/mse.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)  # bf16 inputs keep their dtype
    diff = preds - target
    return torch.sum(diff * diff), target.numel()


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs, squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds, target, squared: bool = True, device=None) -> Tensor:
    """Mean squared error (RMSE with ``squared=False``)."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
