"""Pairwise manhattan distance (counterpart of ``metrics_tpu/functional/pairwise/manhattan.py``)."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _rowwise_chunks,
    _zero_diagonal,
)


def _pairwise_manhattan_distance_update(x, y=None, zero_diagonal: Optional[bool] = None, device=None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    distance = _rowwise_chunks(x, y, lambda diff: diff.abs_().sum(dim=-1))
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return distance


def pairwise_manhattan_distance(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None, device=None
) -> Tensor:
    """Pairwise manhattan distance between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_manhattan_distance_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
