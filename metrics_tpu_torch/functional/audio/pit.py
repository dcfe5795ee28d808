"""Permutation-invariant training (counterpart of ``metrics_tpu/functional/audio/pit.py``).

Up to ``_EXHAUSTIVE_SPK_LIMIT`` speakers every permutation is scored at once on the
device: one gather over the ``(spk!, spk)`` permutation table and a mean. Above it,
scipy's ``linear_sum_assignment`` runs on the host, one matrix per sample.
"""
from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import _build
from metrics_tpu_torch.utils import imports
from metrics_tpu_torch.utils.data import to_tensor

_EXHAUSTIVE_SPK_LIMIT = 8

# permutation tables by speaker count, kept on the host, and their copies by device
_ps_cache: Dict[int, np.ndarray] = {}
_ps_device_cache: Dict[Tuple[int, str], Tensor] = {}


def _perm_table(spk_num: int, device: torch.device) -> Tensor:
    """All permutations of ``spk_num`` speakers as an ``(spk!, spk)`` int64 tensor.

    Copied to ``device`` once, at its first use (an eager update): a host-to-device
    copy synchronises, and a later captured step reuses the copy."""
    key = (spk_num, str(torch.device(device)))
    table = _ps_device_cache.get(key)
    if table is None:
        if spk_num not in _ps_cache:
            _ps_cache[spk_num] = np.asarray(list(permutations(range(spk_num))), np.int64)
        table = torch.as_tensor(_ps_cache[spk_num], device=device)
        if not _build.faking(table):  # a trace on fake tensors (analysis/san) leaves the cache as it was
            _ps_device_cache[key] = table
    return table


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, larger_is_better: bool) -> Tuple[Tensor, Tensor]:
    """Best permutation by scoring every one; ``metric_mtx[b, t, p]`` is prediction
    ``p``'s metric against target ``t``."""
    spk_num = metric_mtx.shape[-1]
    ps = _perm_table(spk_num, metric_mtx.device)  # (perm_num, spk)
    targets = torch.arange(spk_num, device=metric_mtx.device)
    scores = metric_mtx[:, targets[None, :], ps].mean(dim=-1)  # (batch, perm_num)
    best_indexes = torch.argmax(scores, dim=-1) if larger_is_better else torch.argmin(scores, dim=-1)
    best_metric = torch.gather(scores, 1, best_indexes[:, None])[:, 0]
    return best_metric, ps[best_indexes]


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, larger_is_better: bool) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment on the host (scipy), one matrix per sample."""
    from scipy.optimize import linear_sum_assignment

    mtx = metric_mtx.detach().cpu().numpy()
    best_perm = torch.as_tensor(
        np.stack([linear_sum_assignment(pwm, maximize=larger_is_better)[1] for pwm in mtx]).astype(np.int64),
        device=metric_mtx.device,
    )
    best_metric = torch.take_along_dim(metric_mtx, best_perm[:, :, None], dim=2).mean(dim=(-1, -2))
    return best_metric, best_perm


def permutation_invariant_training(
    preds, target, metric_func: Callable, eval_func: str = "max", device=None, **kwargs: Any
) -> Tuple[Tensor, Tensor]:
    """``(best_metric (batch,), best_perm (batch, spk))`` of estimates ``preds`` against
    references ``target``, both ``(batch, spk, ...)``; ``best_perm[b, t]`` is the
    prediction assigned to target ``t``. ``metric_func(preds[:, i], target[:, j],
    **kwargs)`` gives one value per sample; ``eval_func`` is ``"max"`` or ``"min"``."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.dim() < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    spk_num = target.shape[1]
    rows = []
    for target_idx in range(spk_num):
        cols = [metric_func(preds[:, preds_idx, ...], target[:, target_idx, ...], **kwargs) for preds_idx in range(spk_num)]
        rows.append(torch.stack(cols, dim=-1))
    metric_mtx = torch.stack(rows, dim=-2)  # (batch, target, preds)

    larger_is_better = eval_func == "max"
    if spk_num <= _EXHAUSTIVE_SPK_LIMIT:
        return _find_best_perm_by_exhaustive_method(metric_mtx, larger_is_better)
    if not imports._SCIPY_AVAILABLE:
        raise ModuleNotFoundError(
            f"permutation_invariant_training with {spk_num} > {_EXHAUSTIVE_SPK_LIMIT} speakers requires `scipy` "
            "for the linear-sum-assignment solver. Install it with `pip install scipy`."
        )
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, larger_is_better)


def pit_permutate(preds, perm, device=None) -> Tensor:
    """``preds[b, spk, ...]`` reordered by ``perm[b, spk]``."""
    preds = to_tensor(preds, device)
    perm = to_tensor(perm, preds.device).to(torch.int64)
    return torch.take_along_dim(preds, perm.reshape(perm.shape + (1,) * (preds.dim() - 2)), dim=1)
