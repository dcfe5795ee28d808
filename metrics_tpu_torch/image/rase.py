"""RASE metric (counterpart of ``metrics_tpu/image/rase.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.rase import _rase_compute, _rase_update


class RelativeAverageSpectralError(Metric):
    """RASE with streaming sliding-window state (map-shaped states start as scalar
    placeholders, as in :class:`RootMeanSquaredErrorUsingSlidingWindow`)."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    _lazy_state_shapes: bool = True

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("rmse_map", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        initialized = self.rmse_map.ndim != 0
        self.rmse_map, self.target_sum, self.total_images = _rase_update(
            preds,
            target,
            self.window_size,
            self.rmse_map if initialized else None,
            self.target_sum if initialized else None,
            self.total_images if initialized else None,
        )

    def compute(self) -> Tensor:
        return _rase_compute(self.rmse_map, self.target_sum, self.total_images, self.window_size)
