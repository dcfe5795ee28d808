"""PermutationInvariantTraining (counterpart of ``metrics_tpu/audio/pit.py``)."""
from typing import Any, Callable

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training

# the Metric keyword arguments; every other keyword goes to ``metric_func``
_BASE_KWARGS = (
    "device", "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn", "distributed_available_fn",
    "sync_on_compute", "cat_capacity",
)


class PermutationInvariantTraining(Metric):
    """Mean best-permutation metric value for multi-talker separation.

    ``metric_func(preds[:, i], target[:, j], **kwargs)`` gives one value per sample;
    ``eval_func`` is ``"max"`` (higher is better) or ``"min"``.
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in _BASE_KWARGS if k in kwargs}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + torch.sum(pit_metric)
        self.total = self.total + pit_metric.numel()

    def compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
