"""SignalNoiseRatio and ScaleInvariantSignalNoiseRatio (counterpart of ``metrics_tpu/audio/snr.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio


class SignalNoiseRatio(Metric):
    """Mean SNR in dB over all seen samples."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean
        self.add_state("sum_snr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + torch.sum(snr_batch)
        self.total = self.total + snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Mean SI-SNR in dB over all seen samples."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + torch.sum(si_snr_batch)
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_si_snr / self.total
