"""State reducers, tensor utilities and the histogram entry points.

Counterpart of ``metrics_tpu/utils/data.py``. ``_bincount``/``_bincount_weighted``
dispatch through :mod:`metrics_tpu_torch.ops.histogram`: the hand-written CUDA
kernel for CUDA tensors with up to ``KERNEL_MAX_BINS`` bins, a scatter-add with
drop semantics above that, and the plain version for CPU tensors.
"""
from typing import List, Optional, Union

import numpy as np
import torch
from torch import Tensor


def _count_dtype() -> torch.dtype:
    """dtype of unbounded count accumulators (stat-score and confusion-matrix states).

    int64 is exact at any realistic count; it equals the JAX package under
    ``jax_enable_x64``, whose default float32 is exact only up to 2^24.
    """
    return torch.int64


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and absent: there is
    no silent CPU path.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "metrics_tpu_torch runs on CUDA by default, but no CUDA device is available;"
                " pass device='cpu' to run on the CPU."
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = torch.cuda.current_device() if a.index is None else a.index
    ib = torch.cuda.current_device() if b.index is None else b.index
    return ia == ib


def to_tensor(x, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """An entry point's input as a tensor.

    A tensor stays where it is (and raises if ``device`` names another device); any
    other array-like is copied to ``device``, which defaults to ``cuda``.
    """
    if isinstance(x, Tensor):
        if device is not None and not _same_device(x.device, torch.device(device)):
            raise RuntimeError(f"Input tensor is on {x.device}, but the computation runs on {device}.")
        return x
    return torch.as_tensor(np.asarray(x), device=_resolve_device(device))


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a list of tensors along dim 0."""
    if isinstance(x, Tensor):
        return x
    x = [torch.atleast_1d(v) for v in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(x, dim=0).values


def _one_hot(x: Tensor, num_classes: int) -> Tensor:
    """int32 one-hot along a new last axis; ids outside ``[0, num_classes)`` give a zero row.

    Matches ``jax.nn.one_hot`` (``torch.nn.functional.one_hot`` raises on such ids).
    """
    return (x.unsqueeze(-1) == torch.arange(num_classes, device=x.device)).to(torch.int32)


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """Integer labels ``(N, ...)`` -> one-hot ``(N, C, ...)``."""
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    return torch.movedim(_one_hot(label_tensor, num_classes), -1, 1)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 0/1 mask of the top-k entries along ``dim``.

    Ties go to the lower index, as with ``jax.lax.top_k``: a stable descending sort
    keeps that order, where ``torch.topk`` does not promise one.
    """
    moved = torch.movedim(prob_tensor, dim, -1)
    idx = torch.sort(moved, dim=-1, descending=True, stable=True).indices[..., :topk]
    mask = torch.zeros(moved.shape, dtype=torch.int32, device=moved.device)
    mask.scatter_(-1, idx, 1)
    return torch.movedim(mask, -1, dim)


def _bincount(x: Tensor, minlength: int) -> Tensor:
    """int32 count of each value in ``[0, minlength)``; other values drop."""
    from metrics_tpu_torch.ops import histogram

    return histogram.bincount(x.reshape(-1), minlength)


def _bincount_weighted(x: Tensor, weights: Tensor, minlength: int) -> Tensor:
    """Weighted count of each value in ``[0, minlength)``; other values drop.

    A bool/uint8 mask gives int32 counts, float weights a sum in their dtype.
    """
    from metrics_tpu_torch.ops import histogram

    return histogram.bincount_weighted(x.reshape(-1), weights.reshape(-1), minlength)
