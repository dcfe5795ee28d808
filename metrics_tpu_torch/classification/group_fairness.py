"""Group-fairness metric classes (counterpart of ``metrics_tpu/classification/group_fairness.py``).

States: four ``(num_groups,)`` count tensors ``tp``, ``fp``, ``tn``, ``fn`` (int64),
reduced by sum; each update adds one histogram launch's counts.
"""
import warnings
from typing import Any, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores_update,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
    _groups_format,
    _groups_validation,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.data import _count_dtype


class _AbstractGroupStatScores(Metric):
    """Per-group tp/fp/tn/fn states filled by one histogram per update."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _init_group_states(
        self, num_groups: int, threshold: float, ignore_index: Optional[int], validate_args: bool
    ) -> None:
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        if not isinstance(num_groups, int) or num_groups < 2:
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for s in ("tp", "fp", "tn", "fn"):
            self.add_state(s, torch.zeros(num_groups, dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_states(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)
        preds, target = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, _groups_format(groups), self.num_groups)
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """tp/fp/tn/fn rates of each group."""

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._init_group_states(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        self._update_states(preds, target, groups)

    def compute(self) -> Dict[str, Tensor]:
        results = torch.stack([self.tp, self.fp, self.tn, self.fn], dim=1)
        return {f"group_{i}": group / group.sum() for i, group in enumerate(results)}


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and/or equal opportunity between the groups."""

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if task not in ["demographic_parity", "equal_opportunity", "all"]:
            raise ValueError(
                f"Expected argument `task` to either be ``demographic_parity``,"
                f"``equal_opportunity`` or ``all`` but got {task}."
            )
        self.task = task
        self._init_group_states(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: Tensor, target: Optional[Tensor], groups: Tensor) -> None:
        """``target`` is not used (and may be None) for ``task="demographic_parity"``."""
        if self.task == "demographic_parity":
            if target is not None:
                warnings.warn("The task demographic_parity does not require a target.", UserWarning)
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        self._update_states(preds, target, groups)

    def compute(self) -> Dict[str, Tensor]:
        stats = (self.tp, self.fp, self.tn, self.fn)
        if self.task == "demographic_parity":
            return _compute_binary_demographic_parity(*stats)
        if self.task == "equal_opportunity":
            return _compute_binary_equal_opportunity(*stats)
        return {**_compute_binary_demographic_parity(*stats), **_compute_binary_equal_opportunity(*stats)}
