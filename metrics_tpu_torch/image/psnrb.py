"""PSNR with the blocking effect factor (counterpart of ``metrics_tpu/image/psnrb.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR penalised by the blocking effect factor of block-coded grayscale images."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("bef", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("data_range", torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, bef, n_obs = _psnrb_update(preds, target, block_size=self.block_size)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.bef = self.bef + bef
        self.total = self.total + n_obs
        self.data_range = torch.maximum(self.data_range, target.max() - target.min())

    def compute(self) -> Tensor:
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)
