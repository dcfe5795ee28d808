"""Pairwise linear similarity (counterpart of ``metrics_tpu/functional/pairwise/linear.py``)."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.compute import _safe_matmul, fp32_exact


def _pairwise_linear_similarity_update(x, y=None, zero_diagonal: Optional[bool] = None, device=None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    with fp32_exact():
        distance = _safe_matmul(x, y)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return distance


def pairwise_linear_similarity(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None, device=None
) -> Tensor:
    """Pairwise linear similarity ``<x_i, y_j>``."""
    distance = _pairwise_linear_similarity_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
