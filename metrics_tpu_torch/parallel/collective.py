"""Process topology and the sync gate (counterpart of ``process_topology`` and
``distributed_available`` in ``metrics_tpu/parallel/collective.py``).

The port's sync is the eager tier's: ``Metric.sync`` gathers every state with
:func:`~metrics_tpu_torch.utils.distributed.gather_all_tensors`, stacks and
reduces. The mapped tier of the JAX file (``sync_array``/``sync_pytree``,
``pad_gather``, ``mark_varying``) exists for ``shard_map``/``jit`` and is not
ported.
"""
from typing import Optional, Tuple

import torch.distributed as dist


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
