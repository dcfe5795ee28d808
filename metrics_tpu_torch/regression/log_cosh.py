"""LogCoshError (counterpart of ``metrics_tpu/regression/log_cosh.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update


class LogCoshError(Metric):
    """LogCosh error."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_log_cosh_error, n_obs = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + sum_log_cosh_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)
