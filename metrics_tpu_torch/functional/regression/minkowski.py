"""Minkowski distance (counterpart of ``metrics_tpu/functional/regression/minkowski.py``)."""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.exceptions import MetricsUserError


def _check_p(p: float) -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise MetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    _check_same_shape(preds, targets)
    _check_p(p)
    preds, targets = _as_float(preds), _as_float(targets)
    return torch.sum(torch.abs(preds - targets) ** p)


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    return distance ** (1.0 / p)


def minkowski_distance(preds, targets, p: float, device=None) -> Tensor:
    """Minkowski distance."""
    preds = to_tensor(preds, device)
    targets = to_tensor(targets, preds.device)
    minkowski_dist_sum = _minkowski_distance_update(preds, targets, p)
    return _minkowski_distance_compute(minkowski_dist_sum, p)
