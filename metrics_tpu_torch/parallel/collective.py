"""Process topology, the sync gate, and the mapped sync tier (counterpart of
``metrics_tpu/parallel/collective.py``).

The eager tier is ``Metric.sync``: every state gathered with
:func:`~metrics_tpu_torch.utils.distributed.gather_all_tensors`, stacked and
reduced. The mapped tier below is what the pure ``sync_state`` uses
(:func:`sync_array`, :func:`sync_pytree`, :func:`pad_gather`): a reduction per state
by its kind, ``all_reduce`` SUM/MAX/MIN (mean as the sum over the world), a gather
for ``cat`` and for ``None`` or a callable (stacked), and
:func:`~metrics_tpu_torch.core.state.cat_sync` for a ``CatBuffer``.

Deviation from the JAX package: the JAX tier runs inside ``shard_map`` over a mesh
axis name; here it runs in every rank of a ``torch.distributed`` process group,
which takes the place of the axis (``None``: no sync, the identity). Every rank of
the group must call it with the same state names. ``mark_varying`` and
``replicate_gathered`` exist for ``shard_map``'s type checker and have no torch
meaning, so they are not ported.
"""
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

ReduceFx = Union[str, Callable, None]
_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_topology(process_index: Optional[int] = None, process_count: Optional[int] = None) -> Tuple[int, int]:
    """``(rank, world)`` of this process: ``torch.distributed``'s default group when
    one is initialised, else ``(0, 1)``; explicit values override either."""
    if process_count is None:
        process_count = dist.get_world_size() if _initialized() else 1
    if process_index is None:
        process_index = dist.get_rank() if _initialized() else 0
    rank, world = int(process_index), int(process_count)
    if not 0 <= rank < world:
        raise ValueError(f"process_index {rank} out of range for process_count {world}")
    return rank, world


def distributed_available() -> bool:
    """Default ``distributed_available_fn``: an initialised process group of more
    than one process."""
    return _initialized() and dist.get_world_size() > 1


def all_gather_equal(x: Tensor, group: Any) -> Tensor:
    """Every rank's ``x`` (of one shape on all ranks), stacked on a new leading axis
    in rank order. A bool tensor travels as uint8."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    out = torch.stack(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def sync_array(x: Tensor, reduce_fx: ReduceFx, group: Any) -> Tensor:
    """One state reduced over ``group`` by its kind: ``all_reduce`` for sum, mean
    (the sum over the world, divided), max and min; a gather concatenated on axis 0
    for ``cat`` (rows may differ between ranks); the states stacked in rank order
    for ``None``, and the callable applied to that stack."""
    if reduce_fx in _OPS:
        flag = x.dtype == torch.bool
        y = x.to(torch.uint8) if flag else x.clone()
        dist.all_reduce(y, op=_OPS[reduce_fx], group=group)
        if reduce_fx == "mean":
            return y / dist.get_world_size(group)
        return y.to(torch.bool) if flag else y
    if reduce_fx == "cat":
        from metrics_tpu_torch.utils.distributed import gather_all_tensors

        return torch.cat(gather_all_tensors(torch.atleast_1d(x), group=group), dim=0)
    stacked = all_gather_equal(x, group)
    return reduce_fx(stacked) if callable(reduce_fx) else stacked


def sync_pytree(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    group: Optional[Any],
    cat_meta: Optional[Dict[str, tuple]] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """A state dict (name -> tensor, list of tensors or ``CatBuffer``) synced over
    ``group``; the identity for ``group=None``.

    A list state is concatenated first and gathered as one tensor, also where it is
    empty on some rank (as a ``(0, *item_shape)`` tensor of its declared row type,
    from ``cat_meta``), so that every rank joins every collective; it comes back as
    a one-tensor list, or ``[]`` when empty on every rank.
    """
    if group is None:
        return state
    from metrics_tpu_torch.core.state import CatBuffer, cat_sync

    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx = reductions.get(name, "sum")
        if isinstance(value, CatBuffer):
            synced = cat_sync(value, group)
            out[name] = CatBuffer(fx(synced.data), synced._count, synced._overflow) if callable(fx) else synced
        elif isinstance(value, (list, tuple)):
            if value:
                local = torch.cat([torch.atleast_1d(v) for v in value], dim=0)
            else:
                item_shape, dtype, _ = (cat_meta or {}).get(name, ((), None, 0))
                local = torch.empty((0, *item_shape), dtype=dtype or torch.float32, device=device)
            gathered = sync_array(local, "cat", group)
            if gathered.numel() == 0 and not value:
                out[name] = []
            else:
                out[name] = [fx(gathered) if callable(fx) else gathered]
        else:
            out[name] = sync_array(value, fx, group)
    return out


def pad_gather(x: Tensor, valid: Tensor, group: Any) -> Tuple[Tensor, Tensor]:
    """A fixed-capacity buffer and its valid count from every rank: the buffers
    concatenated on axis 0 in rank order (``(world * capacity, ...)``) and the
    counts ``(world,)``. Every rank's buffer has the same shape."""
    gathered = all_gather_equal(x, group)
    counts = all_gather_equal(torch.atleast_1d(valid), group)
    return gathered.reshape(-1, *x.shape[1:]), counts.reshape(-1)
