"""Sliding-window RMSE metric (counterpart of ``metrics_tpu/image/rmse_sw.py``)."""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """Sliding-window RMSE with streaming state.

    The map-shaped states start as scalar placeholders and take the image's shape at
    the first update (a 0-d ``rmse_map`` marks a metric not updated yet).
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    _lazy_state_shapes: bool = True

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("rmse_map", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.rmse_map.ndim == 0:
            rmse_val_sum, rmse_map, total = None, None, None
        else:
            rmse_val_sum, rmse_map, total = self.rmse_val_sum, self.rmse_map, self.total_images
        self.rmse_val_sum, self.rmse_map, self.total_images = _rmse_sw_update(
            preds, target, self.window_size, rmse_val_sum, rmse_map, total
        )

    def compute(self) -> Optional[Tensor]:
        rmse, _ = _rmse_sw_compute(self.rmse_val_sum, self.rmse_map, self.total_images)
        return rmse
