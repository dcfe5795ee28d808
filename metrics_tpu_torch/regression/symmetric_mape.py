"""SymmetricMeanAbsolutePercentageError (counterpart of ``metrics_tpu/regression/symmetric_mape.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.symmetric_mape import (
    _symmetric_mean_absolute_percentage_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
)


class SymmetricMeanAbsolutePercentageError(Metric):
    """Symmetric mean absolute percentage error."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        return _symmetric_mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
