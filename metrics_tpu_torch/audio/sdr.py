"""SignalDistortionRatio and ScaleInvariantSignalDistortionRatio (counterpart of ``metrics_tpu/audio/sdr.py``)."""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio


class SignalDistortionRatio(Metric):
    """Mean SDR in dB over all seen samples (the optimal-distortion-filter variant,
    solved in float64); ``use_cg_iter`` is accepted for API parity and ignored."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self, use_cg_iter: Optional[int] = None, filter_length: int = 512, zero_mean: bool = False,
        load_diag: Optional[float] = None, **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + torch.sum(sdr_batch)
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Mean SI-SDR in dB over all seen samples."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + torch.sum(si_sdr_batch)
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
