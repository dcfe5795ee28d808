"""WMAPE (counterpart of ``metrics_tpu/functional/regression/wmape.py``)."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _weighted_mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _as_float(preds), _as_float(target)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = 1.17e-06
) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds, target, device=None) -> Tensor:
    """Weighted mean absolute percentage error."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
