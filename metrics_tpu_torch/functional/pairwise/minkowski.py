"""Pairwise minkowski distance (counterpart of ``metrics_tpu/functional/pairwise/minkowski.py``)."""
from typing import Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _rowwise_chunks,
    _zero_diagonal,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError


def _pairwise_minkowski_distance_update(
    x, y=None, exponent: Union[int, float] = 2, zero_diagonal: Optional[bool] = None, device=None
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise MetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {exponent}")
    _orig_dtype = x.dtype
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(acc_dtype)
    y = y.to(acc_dtype)
    distance = _rowwise_chunks(x, y, lambda diff: diff.abs_().pow_(exponent).sum(dim=-1)) ** (1.0 / exponent)
    distance = distance.to(_orig_dtype)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return distance


def pairwise_minkowski_distance(
    x,
    y=None,
    exponent: Union[int, float] = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
    device=None,
) -> Tensor:
    """Pairwise minkowski distance of order ``exponent`` between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
