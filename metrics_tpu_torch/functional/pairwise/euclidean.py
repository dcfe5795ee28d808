"""Pairwise euclidean distance (counterpart of ``metrics_tpu/functional/pairwise/euclidean.py``).

``x_norm + y_norm - 2 x y^T``, clamped at 0 and square-rooted, as in the JAX package:
the O(N M d) work is one matmul. Inputs accumulate in float32, or float64 when given.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.compute import fp32_exact


def _pairwise_euclidean_distance_update(x, y=None, zero_diagonal: Optional[bool] = None, device=None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    _orig_dtype = x.dtype
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(acc_dtype)
    y = y.to(acc_dtype)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)
    with fp32_exact():
        distance = (x_norm + y_norm - 2 * x @ y.T).to(_orig_dtype)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return torch.sqrt(torch.clamp(distance, min=0.0))


def pairwise_euclidean_distance(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None, device=None
) -> Tensor:
    """Pairwise euclidean distance between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_euclidean_distance_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
