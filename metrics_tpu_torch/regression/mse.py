"""MeanSquaredError (counterpart of ``metrics_tpu/regression/mse.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update


class MeanSquaredError(Metric):
    """Mean squared error (RMSE with ``squared=False``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
