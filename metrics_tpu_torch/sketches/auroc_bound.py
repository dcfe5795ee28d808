"""Streaming AUROC and average precision with certified bounds, in fixed-size state
(counterpart of ``metrics_tpu/sketches/auroc_bound.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.ops.rank import (
    auroc_bounds_from_hists,
    average_precision_bounds_from_hists,
    class_bucket_counts,
    monotone_key_descending,
)
from metrics_tpu_torch.sketches.base import SketchMetric


class StreamingAUROCBound(SketchMetric):
    """Binary AUROC and average-precision brackets from two histograms: no cat buffer,
    no sort.

    The state is one positive and one negative int32 histogram over the top ``bits``
    bits of the order-preserving score key (``2·2^bits`` counters, 32 KB at the
    default 12 bits), counted by the histogram kernel's mask mode (two launches an
    update). ``compute`` returns the certified ``auroc_lower/mid/upper`` and
    ``ap_lower/mid/upper``: the exact values lie inside. Resolution is per binade (the
    top key bits are the sign and exponent), so scores packed into one binade see
    brackets near ``2^-(bits-9)`` wide. ``dist_reduce_fx="sum"``: merges and syncs are
    exact histogram additions.

    Inputs: ``preds`` float scores (NaN-free), ``target`` 1 for positive, anything
    else negative.

    Args:
        bits: histogram resolution, ``2^bits`` buckets (4 to 14).
    """

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_signature_attrs = ("bits",)

    def __init__(self, bits: int = 12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(bits, int) or not 4 <= bits <= 14:
            raise ValueError(f"Argument `bits` must be an int in [4, 14], got {bits}")
        self.bits = bits
        nb = 1 << bits
        self.add_sketch_state("pos_hist", torch.zeros(nb, dtype=torch.int32), "sum")
        self.add_sketch_state("neg_hist", torch.zeros(nb, dtype=torch.int32), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate a batch of (score, binary label) pairs."""
        preds = preds.reshape(-1)
        target = target.reshape(-1)
        keys = monotone_key_descending(preds)
        valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
        pos, neg = class_bucket_counts(keys, target == 1, valid, self.bits)
        self.pos_hist = self.pos_hist + pos
        self.neg_hist = self.neg_hist + neg

    def compute(self) -> dict:
        """The certified brackets (all 0 when a class is absent)."""
        au_lo, au_hi = auroc_bounds_from_hists(self.pos_hist, self.neg_hist)
        ap_lo, ap_hi = average_precision_bounds_from_hists(self.pos_hist, self.neg_hist)
        return {
            "auroc_lower": au_lo,
            "auroc_mid": 0.5 * (au_lo + au_hi),
            "auroc_upper": au_hi,
            "ap_lower": ap_lo,
            "ap_mid": 0.5 * (ap_lo + ap_hi),
            "ap_upper": ap_hi,
        }
