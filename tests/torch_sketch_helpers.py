"""float64 references of the port's average-precision bracket (``tests/test_torch_tolerance.py``
and ``tests/test_torch_sketches.py``).

The port's bracket is not the JAX package's: the JAX ψ expansion has a sign error and
its upper bound leaves out runs of tied positives (``metrics_tpu_torch/ops/rank.py``).
These references compute the port's closed forms in float64 with scipy's digamma, from
histograms that the tests hold bit-equal to the JAX package's.
"""
import numpy as np
from scipy.special import digamma


def ap_bounds64(pos_hist, neg_hist):
    """[lower, upper] of the tie-collapsed AP along the last axis, float64."""
    pos = np.asarray(pos_hist, np.float64)
    neg = np.asarray(neg_hist, np.float64)
    p_prev = np.cumsum(pos, -1) - pos
    n_prev = np.cumsum(neg, -1) - neg
    t_prev = p_prev + n_prev
    best = pos * (p_prev + pos) / np.maximum(t_prev + pos, 1.0)
    a = t_prev + neg + 1.0
    worst = pos - (n_prev + neg) * (digamma(a + pos) - digamma(a))
    total = pos.sum(-1)
    lo = np.where(total > 0, worst.sum(-1) / np.maximum(total, 1.0), 0.0)
    hi = np.where(total > 0, best.sum(-1) / np.maximum(total, 1.0), 0.0)
    return lo, hi


def ap_midpoint64(pos_hist, neg_hist):
    """The served AP: the bracket's midpoint, NaN for a lane without positives."""
    lo, hi = ap_bounds64(pos_hist, neg_hist)
    return np.where(np.asarray(pos_hist).sum(-1) > 0, 0.5 * (lo + hi), np.nan)


def reduce64(res, average, weights):
    """The classes' NaN-dropping macro / weighted reduction of per-lane values."""
    if average in (None, "none"):
        return res
    keep = ~np.isnan(res)
    if average == "macro":
        return res[keep].sum() / keep.sum()
    w = np.where(keep, np.asarray(weights, np.float64), 0.0)
    return np.where(keep, res * w / w.sum(), 0.0).sum()
