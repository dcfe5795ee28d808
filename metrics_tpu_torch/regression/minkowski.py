"""MinkowskiDistance (counterpart of ``metrics_tpu/regression/minkowski.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.minkowski import (
    _check_p,
    _minkowski_distance_compute,
    _minkowski_distance_update,
)


class MinkowskiDistance(Metric):
    """Minkowski distance."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, targets, self.p)

    def compute(self) -> Tensor:
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)
