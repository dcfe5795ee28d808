"""Drift between a reference histogram and the live stream (KL, PSI, total
variation); counterpart of ``metrics_tpu/sketches/drift.py``."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.ops.sketch import counts_into_bins
from metrics_tpu_torch.sketches.base import SketchMetric


class HistogramDrift(SketchMetric):
    """Distribution drift between a reference window and the live stream.

    Two int32 histograms over ``[low, high)`` in ``num_bins`` linear bins plus an
    under- and an overflow bin (±inf included; NaN ignored): ``update(x,
    reference=True)`` fills the reference, ``update(x)`` the live one, each in one
    mask-mode launch of the histogram kernel. ``compute`` gives ``kl`` (KL(live‖ref))
    and ``psi`` on the Jeffreys-smoothed (+0.5 a bin) distributions and ``tv`` (total
    variation) on the raw ones. :meth:`reset_live` starts a new live window and keeps
    the reference.

    Args:
        num_bins: interior bins (at least 2).
        low, high: the binned value range.
    """

    higher_is_better: bool = False
    _update_signature_attrs = ("num_bins", "low", "high")

    def __init__(self, num_bins: int = 64, low: float = 0.0, high: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_bins, int) or num_bins < 2:
            raise ValueError(f"Argument `num_bins` must be an int >= 2, got {num_bins}")
        if not high > low:
            raise ValueError(f"Argument `high` must exceed `low`, got [{low}, {high})")
        self.num_bins = num_bins
        self.low = float(low)
        self.high = float(high)
        self.add_sketch_state("ref_hist", torch.zeros(num_bins + 2, dtype=torch.int32), "sum")
        self.add_sketch_state("live_hist", torch.zeros(num_bins + 2, dtype=torch.int32), "sum")

    def _bin(self, values: Tensor) -> Tensor:
        x = torch.as_tensor(values, device=self.device).reshape(-1).to(torch.float32)
        scale = torch.tensor(self.num_bins / (self.high - self.low), dtype=torch.float32)
        low = torch.tensor(self.low, dtype=torch.float32)
        # clamped in float space (±inf never reaches the int cast), then shifted by 1 so
        # that slot 0 and slot num_bins + 1 are the edge bins
        idx_f = torch.clamp(torch.floor((x - low) * scale), -1.0, float(self.num_bins))
        valid = ~torch.isnan(x)
        idx = torch.where(valid, idx_f, -1.0).to(torch.int32) + 1
        return counts_into_bins(idx, valid, self.num_bins + 2)

    def update(self, values: Tensor, reference: bool = False) -> None:
        """Accumulate a batch into the live (default) or the reference histogram."""
        hist = self._bin(values)
        if reference:
            self.ref_hist = self.ref_hist + hist
        else:
            self.live_hist = self.live_hist + hist

    def reset_live(self) -> None:
        """Start a new live window, keeping the reference histogram."""
        self.live_hist = torch.zeros_like(self.live_hist)
        self._computed = None

    def compute(self) -> dict:
        """``kl``, ``psi`` (smoothed) and ``tv`` (exact), float32."""
        ref = self.ref_hist.to(torch.float32)
        live = self.live_hist.to(torch.float32)
        k = float(ref.shape[-1])
        p = (live + 0.5) / (torch.sum(live, -1, keepdim=True) + 0.5 * k)
        q = (ref + 0.5) / (torch.sum(ref, -1, keepdim=True) + 0.5 * k)
        log_ratio = torch.log(p) - torch.log(q)
        p_raw = live / torch.clamp(torch.sum(live, -1, keepdim=True), min=1.0)
        q_raw = ref / torch.clamp(torch.sum(ref, -1, keepdim=True), min=1.0)
        return {
            "kl": torch.sum(p * log_ratio, -1),
            "psi": torch.sum((p - q) * log_ratio, -1),
            "tv": 0.5 * torch.sum(torch.abs(p_raw - q_raw), -1),
        }
