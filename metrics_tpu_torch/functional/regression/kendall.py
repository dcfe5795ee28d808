"""Kendall rank correlation, tau-a/b/c (counterpart of ``metrics_tpu/functional/regression/kendall.py``).

The pair counts of every column come from one :func:`~metrics_tpu_torch.ops.kendall.pair_counts`
call (one kernel launch on the card), as int64: the JAX package's int32 sums wrap past
n = 65,536. Tau-c's ``m`` counts each column's distinct finite values (one batched sort).
The t-test's p-value is ``torch.special.ndtr`` in float64 on the device, no host read.
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.kendall import pair_counts
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor

_VARIANTS = ("a", "b", "c")
_ALTERNATIVES = ("two-sided", "less", "greater")


def _distinct_finite(x: Tensor) -> Tensor:
    """The number of distinct finite values of each column of ``x`` ``(N, C)`` (±0.0 one value)."""
    s = torch.sort(x, dim=0).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    return (new & torch.isfinite(s)).sum(0)


def _kendall_tau(counts: Tensor, preds: Tensor, target: Tensor, variant: str) -> Tensor:
    """Tau of each column from its ``(C, 4)`` counts, float64."""
    n = preds.shape[0]
    con, dis, tx, ty = counts.to(torch.float64).unbind(1)
    n_pairs = n * (n - 1) / 2
    if variant == "a":
        return (con - dis) / n_pairs
    if variant == "b":
        return (con - dis) / torch.sqrt((n_pairs - tx) * (n_pairs - ty))
    m = torch.minimum(_distinct_finite(preds), _distinct_finite(target)).to(torch.float64)
    return 2 * (con - dis) / (n**2 * (m - 1) / m)


def _p_value(tau: Tensor, n: int, alternative: str) -> Tensor:
    """The normal-approximation p-value of each tau, float64 on tau's device."""
    var = (2 * (2 * n + 5)) / (9 * n * (n - 1))
    z = tau.to(torch.float64) / var**0.5
    if alternative == "two-sided":
        return 2 * torch.special.ndtr(-torch.abs(z))
    if alternative == "greater":
        return torch.special.ndtr(-z)
    return torch.special.ndtr(z)


def kendall_rank_corrcoef(
    preds, target, variant: str = "b", t_test: bool = False, alternative: Optional[str] = "two-sided", device=None
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Kendall rank correlation (tau-a/b/c), with the t-test's p-value if ``t_test``."""
    if variant not in _VARIANTS:
        raise ValueError(f"Argument `variant` is expected to be one of ('a', 'b', 'c'), but got {variant}")
    if t_test and alternative not in _ALTERNATIVES:
        raise ValueError(
            f"Argument `alternative` is expected to be one of ('two-sided', 'less', 'greater'), but got {alternative}"
        )
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    one_d = preds.dim() == 1
    p = preds[:, None] if one_d else preds
    t = target[:, None] if one_d else target
    tau64 = _kendall_tau(pair_counts(p, t), p, t, variant)
    tau = (tau64[0] if one_d else tau64).to(torch.float32)
    if not t_test:
        return tau
    p_value = _p_value(tau, preds.shape[0], alternative)
    return tau, p_value.to(torch.float32)
