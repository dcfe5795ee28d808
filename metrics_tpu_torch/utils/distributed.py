"""Reductions and the eager cross-process gather (counterpart of
``metrics_tpu/utils/distributed.py``).

``reduce`` / ``class_reduce`` are plain tensor math. :func:`gather_all_tensors` is
the transport of ``Metric.sync``: a ``torch.distributed.all_gather`` over the
states' own device (NCCL on the card, or ``gloo``, which stages CUDA tensors
through the host by itself), with the JAX package's ragged path: every rank's
shape is gathered first, each tensor is zero-padded to the per-dim max, gathered,
and trimmed back to its rank's own shape.

Deviation from the JAX package: ``group`` is a ``torch.distributed.ProcessGroup``
(PyTorch has real sub-communicators) where the JAX package takes a sequence of
process indices.
"""
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.compute import _safe_divide

# dtypes a state may hold, by the code the shape exchange sends for them
_DTYPES = (
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)
_MAX_NDIM = 8


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Reduce ``x`` by ``"elementwise_mean"``, ``"sum"`` or ``"none"``."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Class-wise fraction reduced by micro / macro / weighted / none, with 0/0 -> 0."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else _safe_divide(num, denom)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights.to(fraction.dtype) / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction

    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def _pad_to(x: Tensor, shape: Sequence[int]) -> Tensor:
    """Zero-pad ``x`` at the end of each dim up to ``shape``."""
    pads: List[int] = []
    for d, s in zip(reversed(x.shape), reversed(list(shape))):
        pads += [0, int(s) - int(d)]
    if not any(pads):
        return x
    return F.pad(x, pads)


def _trim_to(x: Tensor, shape: Sequence[int]) -> Tensor:
    """Slice ``x`` back down to ``shape`` (inverse of :func:`_pad_to`)."""
    return x[tuple(slice(0, int(s)) for s in shape)]


def _header(x: Tensor) -> List[int]:
    if x.dim() > _MAX_NDIM:
        raise ValueError(f"gather_all_tensors: a state of {x.dim()} dims exceeds the {_MAX_NDIM} it can send")
    return [_DTYPES.index(x.dtype), x.dim(), *x.shape, *([0] * (_MAX_NDIM - x.dim()))]


def all_gather_ragged(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Every rank's ``result``, in rank order, through ``torch.distributed.all_gather``.

    The collective body of :func:`gather_all_tensors`, run even on a group of one
    rank. Ranks first exchange each tensor's dtype and shape. An empty tensor takes
    the dtype and trailing shape of the first rank that holds rows, so that a rank
    whose ``cat`` state is empty still joins the gather; a rank with rows whose
    dtype or number of dims differs raises on every rank. Tensors of equal shapes
    go across as they are; otherwise each is zero-padded to the per-dim max,
    gathered, and trimmed back to its rank's shape.
    """
    world = dist.get_world_size(group)
    result = result.contiguous()
    header = torch.tensor(_header(result), dtype=torch.int64, device=result.device)
    headers = [torch.empty_like(header) for _ in range(world)]
    dist.all_gather(headers, header, group=group)
    rows = torch.stack(headers).tolist()
    shapes = [tuple(r[2:2 + r[1]]) for r in rows]
    holders = [i for i, s in enumerate(shapes) if 0 not in s]
    ref = rows[holders[0]] if holders else rows[0]
    for i, (row, shape) in enumerate(zip(rows, shapes)):
        if row[:2] == ref[:2]:
            continue
        if 0 not in shape:
            raise ValueError(
                f"gather_all_tensors: rank {i} holds {_DTYPES[row[0]]} of {row[1]} dims, rank {holders[0]}"
                f" {_DTYPES[ref[0]]} of {ref[1]} dims"
            )
        shapes[i] = (0, *ref[3:2 + ref[1]])
    dtype = _DTYPES[ref[0]]
    rank = dist.get_rank(group)
    if result.dtype != dtype or tuple(result.shape) != shapes[rank]:
        result = result.to(dtype).reshape(shapes[rank])

    if all(s == shapes[0] for s in shapes):
        gathered = [torch.empty_like(result) for _ in range(world)]
        dist.all_gather(gathered, result, group=group)
        return gathered
    max_shape = [max(dims) for dims in zip(*shapes)]
    padded = _pad_to(result, max_shape).contiguous()
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded, group=group)
    return [_trim_to(g, s) for g, s in zip(gathered, shapes)]


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """Eager cross-process all-gather: a list of every rank's ``result``, in rank order.

    Returns ``[result]`` when no process group is initialised or the group has one
    rank; otherwise runs :func:`all_gather_ragged`. ``group`` is a
    ``torch.distributed`` process group (the default group when None).
    """
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return [result]
    return all_gather_ragged(result, group)
