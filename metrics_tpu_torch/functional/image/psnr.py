"""PSNR (counterpart of ``metrics_tpu/functional/image/psnr.py``)."""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.distributed import reduce
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(base)))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(preds: Tensor, target: Tensor, dim=None) -> Tuple[Tensor, Tensor]:
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        return sum_squared_error, torch.full((), target.numel(), device=target.device)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=dim)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    n_obs = 1
    for d in dim_list:
        n_obs *= target.shape[d]
    return sum_squared_error, torch.full((), n_obs, device=target.device)


def peak_signal_noise_ratio(
    preds,
    target,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
    device=None,
) -> Tensor:
    """PSNR: ``10 log10(data_range^2 / MSE)`` in the given ``base``, over all values or per ``dim`` slice."""
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = (target.max() - target.min()).to(torch.float32)
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = torch.tensor(data_range[1] - data_range[0], dtype=torch.float32, device=preds.device)
    else:
        data_range = torch.tensor(float(data_range), dtype=torch.float32, device=preds.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
