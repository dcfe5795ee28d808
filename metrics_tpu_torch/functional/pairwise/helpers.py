"""Shared helpers of the pairwise functions (counterpart of
``metrics_tpu/functional/pairwise/helpers.py``)."""
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor

# bytes of the (rows, M, d) difference block that the elementwise distances build per chunk
_CHUNK_BYTES = 1 << 30


def _check_input(x, y=None, zero_diagonal: Optional[bool] = None, device=None) -> Tuple[Tensor, Tensor, bool]:
    """Validate shapes and default ``zero_diagonal`` (True when ``y`` is None)."""
    x = to_tensor(x, device)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")

    if y is not None:
        y = to_tensor(y, x.device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: Tensor) -> Tensor:
    return distance.clone().fill_diagonal_(0)


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """Reduce an ``[N, M]`` distance matrix along the last dim."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _rowwise_chunks(x: Tensor, y: Tensor, pair_fn: Callable[[Tensor], Tensor]) -> Tensor:
    """``pair_fn(x[i:j, None, :] - y[None, :, :])`` for row chunks of ``x``, concatenated.

    The JAX package builds the whole ``(N, M, d)`` difference tensor; the same sums in
    chunks of rows keep it under ``_CHUNK_BYTES`` (4,096 x 4,096 x 2,048 float32
    features would take 137 GB at once).
    """
    row_bytes = max(1, y.shape[0] * y.shape[1] * x.element_size())
    rows = max(1, _CHUNK_BYTES // row_bytes)
    return torch.cat([pair_fn(x[i : i + rows, None, :] - y[None, :, :]) for i in range(0, x.shape[0], rows)])
