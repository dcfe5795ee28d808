"""Cross-process execution of the port: the sync gate, the process topology, the
mapped sync tier and sharded evaluation.

The DDP recipe: every rank calls ``torch.distributed.init_process_group``, feeds its
own share of the data into its own metrics, and ``compute`` gathers the states of
every rank (``Metric.sync``) before it computes. The pure recipe:
:func:`evaluate_sharded` carries a state dict through ``local_update`` over this
rank's batches, syncs it once (``sync_state``: :func:`sync_pytree`) and computes.
"""
from metrics_tpu_torch.parallel.collective import (
    distributed_available,
    pad_gather,
    process_topology,
    sync_array,
    sync_pytree,
)
from metrics_tpu_torch.parallel.mesh import evaluate_sharded, shard_batch

__all__ = [
    "distributed_available", "evaluate_sharded", "pad_gather", "process_topology", "shard_batch", "sync_array",
    "sync_pytree",
]
