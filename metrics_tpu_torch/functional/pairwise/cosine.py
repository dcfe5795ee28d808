"""Pairwise cosine similarity (counterpart of ``metrics_tpu/functional/pairwise/cosine.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.compute import _safe_matmul, fp32_exact


def _pairwise_cosine_similarity_update(x, y=None, zero_diagonal: Optional[bool] = None, device=None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal, device)
    x = x / torch.linalg.norm(x, ord=2, dim=1, keepdim=True)
    y = y / torch.linalg.norm(y, ord=2, dim=1, keepdim=True)
    with fp32_exact():
        distance = _safe_matmul(x, y)
    if zero_diagonal:
        distance = _zero_diagonal(distance)
    return distance


def pairwise_cosine_similarity(
    x, y=None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None, device=None
) -> Tensor:
    """Pairwise cosine similarity between the rows of ``x`` (and ``y``)."""
    distance = _pairwise_cosine_similarity_update(x, y, zero_diagonal, device)
    return _reduce_distance_matrix(distance, reduction)
