"""Sharded evaluation over ranks (counterpart of ``metrics_tpu/parallel/mesh.py``).

The JAX package evaluates in one SPMD program over a device mesh: per-device local
states carried through a ``lax.scan`` inside ``shard_map``, one collective sync, one
compute. Here the DDP recipe does the same with processes: each rank of a
``torch.distributed`` process group passes its own batches, runs ``local_update``
over them (no host round trip between batches), syncs once with ``sync_state`` and
computes with ``compute_from``.

Deviation from the JAX package: a process group takes the place of the
single-process ``Mesh``, so there is no ``make_data_mesh``; :func:`shard_batch`
becomes a ``(rank, world)`` row split, each rank taking its contiguous block of
rows.
"""
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor
from torch.utils import _pytree as pytree

from metrics_tpu_torch.parallel.collective import process_topology


def shard_batch(batch: Any, rank: Optional[int] = None, world: Optional[int] = None) -> Any:
    """This rank's rows of every tensor in ``batch``: rows ``[rank * n / world,
    (rank + 1) * n / world)`` of each, as the JAX mesh shards axis 0 over devices.
    ``rank`` and ``world`` default to the default process group's."""
    rank, world = process_topology(rank, world)

    def take(x: Any) -> Any:
        if not isinstance(x, Tensor):
            return x
        n = x.shape[0]
        return x[rank * n // world:(rank + 1) * n // world]

    return pytree.tree_map(take, batch)


def _lists_to_buffers(metric: Any, state0: dict, batches: Sequence[Tuple], group: Any) -> dict:
    """The metric's list (``cat``) states as ``CatBuffer``s sized from one probe update.

    One eager ``local_update`` on the first batch tells how many rows each list state
    appends per row of input; the capacity holds that many for all of this rank's
    input rows (and at least the probe's rows for every batch), and every rank takes
    the largest capacity of the group, since every rank's buffer must have one shape
    for the gather. A batch that appends more overflows, and the overflow NaN-poisons
    ``compute_from``.
    """
    from metrics_tpu_torch.core.state import CatBuffer

    leads = [int(b[0].shape[0]) if b and isinstance(b[0], Tensor) and b[0].dim() else 1 for b in batches]
    probe = metric.local_update(state0, *batches[0]) if batches else state0
    specs = {}
    for name, val in probe.items():
        if not isinstance(state0[name], list):
            continue
        if not val:
            raise ValueError(
                f"cat state `{name}` appended nothing on the probe batch; pass"
                " `cat_capacity` explicitly to use evaluate_sharded with this metric"
            )
        appended = sum(torch.atleast_1d(v).shape[0] for v in val)
        item = torch.atleast_1d(val[0])
        _, decl_dtype, decl_fill = metric._cat_meta.get(name, ((), None, 0))
        # the port keeps integer labels as int64 where the JAX package has int32: only
        # float rows into an integer state are a lossy cast
        if decl_dtype is not None and item.is_floating_point() and not decl_dtype.is_floating_point:
            raise ValueError(
                f"cat state `{name}` declares dtype {decl_dtype} but the probe update appended"
                f" {item.dtype}, which the buffer would cast lossily; fix the metric's add_state"
                " declaration or the update's cast"
            )
        capacity = max(appended * len(batches), -(-appended * sum(leads) // max(leads[0], 1)))
        specs[name] = (capacity, tuple(item.shape[1:]), decl_dtype or item.dtype, decl_fill)
    capacities = torch.tensor([spec[0] for spec in specs.values()], dtype=torch.int64, device=metric.device)
    if group is not None and capacities.numel():
        dist.all_reduce(capacities, op=dist.ReduceOp.MAX, group=group)
    out = dict(state0)
    for (name, (_, item_shape, dtype, fill)), capacity in zip(specs.items(), capacities.tolist()):
        out[name] = CatBuffer.create(capacity, item_shape, dtype, fill, metric.device)
    return out


def evaluate_sharded(metric: Any, batches: Sequence[Tuple], group: Optional[Any] = None) -> Any:
    """This rank's share of a sharded evaluation: ``local_update`` over its own
    ``batches`` (tuples of positional update arguments), one ``sync_state`` over
    ``group``, then ``compute_from``. Every rank of the group calls it and gets the
    value over the union of all ranks' batches.

    ``group`` defaults to the default process group when one is initialised (no
    sync otherwise). ``metric`` may be one metric or a whole
    :class:`~metrics_tpu_torch.core.collections.MetricCollection`; list states
    become ``CatBuffer``s first.
    """
    from metrics_tpu_torch.core.collections import MetricCollection

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    state = metric.init_state()
    if isinstance(metric, MetricCollection):
        for name, member in metric.items(keep_base=True, copy_state=False):
            if any(isinstance(v, list) for v in state[name].values()):
                state[name] = _lists_to_buffers(member, state[name], batches, group)
    elif any(isinstance(v, list) for v in state.values()):
        state = _lists_to_buffers(metric, state, batches, group)
    for batch in batches:
        state = metric.local_update(state, *batch)
    if group is not None:
        state = metric.sync_state(state, group)
    return metric.compute_from(state)
