"""ShortTimeObjectiveIntelligibility (counterpart of ``metrics_tpu/audio/stoi.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility


class ShortTimeObjectiveIntelligibility(Metric):
    """Mean STOI over all seen samples (computed on the host)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(fs, int) or fs <= 0:
            raise ValueError(f"Expected argument `fs` to be a positive int, but got {fs}")
        self.fs = fs
        self.extended = extended
        self.add_state("sum_stoi", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(preds, target, self.fs, self.extended)
        self.sum_stoi = self.sum_stoi + torch.sum(stoi_batch)
        self.total = self.total + stoi_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_stoi / self.total
