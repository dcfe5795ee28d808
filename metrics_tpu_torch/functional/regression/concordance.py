"""Concordance correlation (counterpart of ``metrics_tpu/functional/regression/concordance.py``)."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.pearson import (
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
    _zero_moments,
)
from metrics_tpu_torch.utils.data import to_tensor


def _concordance_corrcoef_compute(
    mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor
) -> Tensor:
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    return torch.squeeze(2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2))


def concordance_corrcoef(preds, target, device=None) -> Tensor:
    """Concordance correlation coefficient."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    d = preds.shape[1] if preds.dim() == 2 else 1
    moments = _pearson_corrcoef_update(preds, target, *_zero_moments(preds), num_outputs=d)
    return _concordance_corrcoef_compute(*moments)
