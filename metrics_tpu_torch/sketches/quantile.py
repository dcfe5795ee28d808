"""DDSketch-style relative-error quantile sketch (Masson et al., VLDB 2019);
counterpart of ``metrics_tpu/sketches/quantile.py``."""
import math
from typing import Any, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.ops.sketch import bucket_midpoints, counts_into_bins, log_bucket_index, quantile_gamma
from metrics_tpu_torch.sketches.base import SketchMetric

#: edge_counts slot layout (see :meth:`QuantileSketch.update`)
_NEG_OVER, _NEG_UNDER, _ZERO, _POS_UNDER, _POS_OVER = range(5)


class QuantileSketch(SketchMetric):
    """Streaming quantiles with a per-value relative-error certificate.

    Magnitudes fall into ``2^bits`` geometric buckets per sign (bucket ``i`` covers
    ``[min_value·γ^i, min_value·γ^(i+1))``, ``γ = (1+α)/(1-α)``), plus five edge bins
    (±overflow, ±underflow, exact zeros). A quantile whose rank lands in a regular
    bucket or on an exact zero is within ``relative_error`` of the true order
    statistic; one in an edge bin is estimated and flagged uncertified. NaNs are left
    out of the ranks and counted in ``nan_count``.

    State: ``2·2^bits + 5`` int32 counters under ``sum``. An update is two mask-mode
    launches of the histogram kernel (per sign) up to ``bits=14``, the histogram's
    scatter-add path above.

    Deliberate deviation: ``compute`` takes the cumulative counts in int64 and, past
    2^24 values, the ranks ``floor(q·(n-1))`` in float64: exact at any count. The JAX
    package takes both in float32, so past 2^24 values its slot can miss the exact
    rank's; up to 2^24 the port takes the JAX package's float32 ranks, and the slots
    agree.

    Args:
        relative_error: the certified relative accuracy α (default 1%).
        bits: log2 bucket count per sign (4 to 16).
        min_value: the smallest certifiable nonzero magnitude.
        quantiles: the levels ``compute`` reports.
    """

    higher_is_better = None
    _update_signature_attrs = ("relative_error", "bits", "min_value")

    def __init__(
        self,
        relative_error: float = 0.01,
        bits: int = 11,
        min_value: float = 1e-9,
        quantiles: Sequence[float] = (0.5, 0.9, 0.99),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(bits, int) or not 4 <= bits <= 16:
            raise ValueError(f"Argument `bits` must be an int in [4, 16], got {bits}")
        if not min_value > 0.0:
            raise ValueError(f"Argument `min_value` must be positive, got {min_value}")
        qs = tuple(float(q) for q in quantiles)
        if not qs or not all(0.0 <= q <= 1.0 for q in qs):
            raise ValueError(f"Argument `quantiles` must be levels in [0, 1], got {quantiles}")
        self.relative_error = float(relative_error)
        self.bits = bits
        self.min_value = float(min_value)
        self.quantiles = qs
        self._gamma = quantile_gamma(self.relative_error)
        self._log_gamma = math.log(self._gamma)
        nb = 1 << bits
        self.add_sketch_state("pos_buckets", torch.zeros(nb, dtype=torch.int32), "sum")
        self.add_sketch_state("neg_buckets", torch.zeros(nb, dtype=torch.int32), "sum")
        self.add_sketch_state("edge_counts", torch.zeros(5, dtype=torch.int32), "sum")
        self.add_sketch_state("nan_count", torch.zeros((), dtype=torch.int32), "sum")

    @property
    def max_value(self) -> float:
        """Largest certifiable magnitude, ``min_value · γ^(2^bits)``."""
        return self.min_value * math.exp(self._log_gamma * (1 << self.bits))

    def update(self, values: Tensor) -> None:
        """Bucket a batch of values (any shape, flattened)."""
        x = torch.as_tensor(values, device=self.device).reshape(-1).to(torch.float32)
        nb = 1 << self.bits
        nan = torch.isnan(x)
        idx = log_bucket_index(torch.abs(x), self._log_gamma, self.min_value, nb)
        pos = (x > 0) & ~nan
        neg = (x < 0) & ~nan
        in_range = (idx >= 0) & (idx < nb)
        self.pos_buckets = self.pos_buckets + counts_into_bins(idx, pos & in_range, nb)
        self.neg_buckets = self.neg_buckets + counts_into_bins(idx, neg & in_range, nb)
        over, under = idx >= nb, idx < 0
        edges = torch.stack([
            torch.sum(neg & over, dtype=torch.int32),
            torch.sum(neg & under, dtype=torch.int32),
            torch.sum(x == 0, dtype=torch.int32),
            torch.sum(pos & under, dtype=torch.int32),
            torch.sum(pos & over, dtype=torch.int32),
        ])
        self.edge_counts = self.edge_counts + edges
        self.nan_count = self.nan_count + torch.sum(nan, dtype=torch.int32)

    def compute(self) -> dict:
        """``quantiles`` (float32, one a level, NaN before any value), ``certified``
        (bool a level: the rank landed in a regular bucket or on an exact zero) and the
        declared ``relative_error``."""
        nb = 1 << self.bits
        device = self.pos_buckets.device
        est = bucket_midpoints(nb, self._log_gamma, self.min_value, device)
        edge = self.edge_counts
        # the merged ascending-value order: most negative first
        counts = torch.cat([
            edge[_NEG_OVER:_NEG_OVER + 1], torch.flip(self.neg_buckets, [0]), edge[_NEG_UNDER:_ZERO + 1],
            edge[_POS_UNDER:_POS_UNDER + 1], self.pos_buckets, edge[_POS_OVER:_POS_OVER + 1],
        ])
        half_min = 0.5 * self.min_value
        values = torch.cat([
            torch.tensor([-self.max_value], dtype=torch.float32, device=device), -torch.flip(est, [0]),
            torch.tensor([-half_min, 0.0, half_min], dtype=torch.float32, device=device), est,
            torch.tensor([self.max_value], dtype=torch.float32, device=device),
        ])
        one, zero = torch.ones(1, dtype=torch.bool, device=device), torch.zeros(1, dtype=torch.bool, device=device)
        regular = torch.ones(nb, dtype=torch.bool, device=device)
        certified = torch.cat([zero, regular, zero, one, zero, regular, zero])  # exact zeros: error 0
        cumulative = torch.cumsum(counts.to(torch.int64), 0)
        total = cumulative[-1]
        last = torch.clamp(total - 1, min=0)
        # up to 2^24 values the JAX package's float32 ranks, bit for bit; past it float64
        q32 = torch.tensor(self.quantiles, dtype=torch.float32, device=device)
        q64 = torch.tensor(self.quantiles, dtype=torch.float64, device=device)
        ranks = torch.where(
            total <= 1 << 24, torch.floor(q32 * last.to(torch.float32)).to(torch.float64),
            torch.floor(q64 * last.to(torch.float64)),
        )
        slot = torch.searchsorted(cumulative.to(torch.float64), ranks, right=True)
        slot = torch.clamp(slot, 0, counts.shape[0] - 1)
        nonempty = total > 0
        return {
            "quantiles": torch.where(nonempty, values[slot], float("nan")),
            "certified": certified[slot] & nonempty,
            "relative_error": torch.tensor(self.relative_error, dtype=torch.float32, device=device),
        }
