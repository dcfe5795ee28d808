"""Cross-process execution of the port: the sync gate and the process topology.

The DDP recipe: every rank calls ``torch.distributed.init_process_group``, feeds its
own share of the data into its own metrics, and ``compute`` gathers the states of
every rank (``Metric.sync``) before it computes.
"""
from metrics_tpu_torch.parallel.collective import distributed_available, process_topology

__all__ = ["distributed_available", "process_topology"]
