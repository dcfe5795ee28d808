"""Group-fairness functionals (counterpart of
``metrics_tpu/functional/classification/group_fairness.py``).

Per-group tp/fp/tn/fn come from one histogram over ``group * 4 + 2 * target + pred``
with ``4 * num_groups`` bins: one count-mode launch of the histogram kernel on the
card. Invalid samples (an ignored target, a group id out of range) take the id -1
and drop.
"""
import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _as_inputs,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import _bincount, to_tensor


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    """Group ids must be integers in ``[0, num_groups)`` (the JAX package rejects an id
    equal to ``num_groups`` and negative ids too)."""
    if groups.numel():
        g_min, g_max = groups.min(), groups.max()
        if int(g_max) >= num_groups:
            raise ValueError(
                f"The largest number in the groups tensor is {int(g_max)}, which is larger than the specified"
                f" number of groups {num_groups}. The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
            )
        if int(g_min) < 0:
            raise ValueError(
                f"The smallest number in the groups tensor is {int(g_min)}; negative group ids are not valid."
                " The group identifiers should be ``0, 1, ..., (num_groups - 1)``."
            )
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Expected dtype of argument groups to be int, not {groups.dtype}.")


def _groups_format(groups: Tensor) -> Tensor:
    return groups.reshape(groups.shape[0], -1)


def _binary_groups_stat_scores_update(
    preds: Tensor, target: Tensor, groups: Tensor, num_groups: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-group ``(tp, fp, tn, fn)``, each of shape ``(num_groups,)``, from one histogram."""
    groups = groups.reshape(-1)
    target = target.reshape(-1)
    valid = (target >= 0) & (groups >= 0) & (groups < num_groups)
    ids = groups * 4 + 2 * torch.clamp(target, min=0) + preds.reshape(-1)
    bins = _bincount(torch.where(valid, ids, -1).to(torch.int32), 4 * num_groups).reshape(num_groups, 4)
    # columns: t0p0 = tn, t0p1 = fp, t1p0 = fn, t1p1 = tp
    return bins[:, 3], bins[:, 1], bins[:, 0], bins[:, 2]


def _binary_groups_stat_scores(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> List[Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Group stat scores as a per-group list."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, _groups_format(groups), num_groups)
    return [(tp[g], fp[g], tn[g], fn[g]) for g in range(num_groups)]


def _groups_reduce(group_stats: List[Tuple[Tensor, Tensor, Tensor, Tensor]]) -> Dict[str, Tensor]:
    """Each group's (tp, fp, tn, fn) over its total."""
    return {
        f"group_{group}": torch.stack(stats) / torch.stack(stats).sum() for group, stats in enumerate(group_stats)
    }


def _groups_stat_transform(group_stats: List[Tuple[Tensor, Tensor, Tensor, Tensor]]) -> Dict[str, Tensor]:
    return {name: torch.stack([stat[i] for stat in group_stats]) for i, name in enumerate(("tp", "fp", "tn", "fn"))}


def _rate_ratio(rates: Tensor, pop: Tensor, prefix: str) -> Dict[str, Tensor]:
    """The lowest over the highest rate among the groups with a population, keyed by
    their ids; NaN when fewer than two groups have one."""
    lo = int(torch.argmin(torch.where(pop > 0, rates, float("inf"))))
    hi = int(torch.argmax(torch.where(pop > 0, rates, float("-inf"))))
    ratio = _safe_divide(rates[lo], rates[hi])
    if int(torch.sum(pop > 0)) < 2:
        ratio = torch.full_like(ratio, float("nan"))
    return {f"{prefix}_{lo}_{hi}": ratio}


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    pop = tp + fp + tn + fn
    return _rate_ratio(_safe_divide(tp + fp, pop), pop, "DP")


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    pop = tp + fn
    return _rate_ratio(_safe_divide(tp, pop), pop, "EO")


def _num_groups(groups: Tensor) -> int:
    return int(groups.max()) + 1


def binary_groups_stat_rates(
    preds,
    target,
    groups,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Dict[str, Tensor]:
    """True/false positive and negative rates of each group."""
    preds, target = _as_inputs(preds, target, device)
    groups = to_tensor(groups, preds.device)
    group_stats = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _groups_reduce(group_stats)


def demographic_parity(
    preds,
    groups,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Dict[str, Tensor]:
    """Ratio of the lowest to the highest positive-prediction rate among the groups."""
    preds, groups = _as_inputs(preds, groups, device)
    target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    group_stats = _binary_groups_stat_scores(
        preds, target, groups, _num_groups(groups), threshold, ignore_index, validate_args
    )
    return _compute_binary_demographic_parity(**_groups_stat_transform(group_stats))


def equal_opportunity(
    preds,
    target,
    groups,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Dict[str, Tensor]:
    """Ratio of the lowest to the highest true-positive rate among the groups."""
    preds, target = _as_inputs(preds, target, device)
    groups = to_tensor(groups, preds.device)
    group_stats = _binary_groups_stat_scores(
        preds, target, groups, _num_groups(groups), threshold, ignore_index, validate_args
    )
    return _compute_binary_equal_opportunity(**_groups_stat_transform(group_stats))


def binary_fairness(
    preds,
    target,
    groups,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity (``task``: their names or ``"all"``)."""
    if task not in ["demographic_parity", "equal_opportunity", "all"]:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )
    if task == "demographic_parity":
        if target is not None:
            warnings.warn("The task demographic_parity does not require a target.", UserWarning)
        preds = to_tensor(preds, device)
        target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    preds, target = _as_inputs(preds, target, device)
    groups = to_tensor(groups, preds.device)
    group_stats = _binary_groups_stat_scores(
        preds, target, groups, _num_groups(groups), threshold, ignore_index, validate_args
    )
    stats = _groups_stat_transform(group_stats)
    if task == "demographic_parity":
        return _compute_binary_demographic_parity(**stats)
    if task == "equal_opportunity":
        return _compute_binary_equal_opportunity(**stats)
    return {**_compute_binary_demographic_parity(**stats), **_compute_binary_equal_opportunity(**stats)}
