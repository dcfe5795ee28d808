"""LogCosh error (counterpart of ``metrics_tpu/functional/regression/log_cosh.py``)."""
import math
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def _unsqueeze_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dim() == 2:
        return preds, target
    return preds[:, None], target[:, None]


def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _unsqueeze_tensors(_as_float(preds), _as_float(target))
    diff = preds - target
    # numerically stable log cosh: |d| + log1p(exp(-2|d|)) - log 2
    abs_diff = torch.abs(diff)
    sum_log_cosh_error = torch.squeeze((abs_diff + torch.log1p(torch.exp(-2 * abs_diff)) - math.log(2.0)).sum(0))
    return sum_log_cosh_error, torch.tensor(target.shape[0], device=target.device)


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, n_obs: Tensor) -> Tensor:
    return torch.squeeze(sum_log_cosh_error / n_obs)


def log_cosh_error(preds, target, device=None) -> Tensor:
    """LogCosh error."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    sum_log_cosh_error, n_obs = _log_cosh_error_update(
        preds, target, num_outputs=1 if preds.dim() == 1 else preds.shape[-1]
    )
    return _log_cosh_error_compute(sum_log_cosh_error, n_obs)
