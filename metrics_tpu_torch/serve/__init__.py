"""metrics_tpu_torch.serve: the serving path's tiers (counterpart of part of
``metrics_tpu/serve``).

The async ingestion tier (:mod:`~metrics_tpu_torch.serve.ingest`) takes batch
arrival off the accumulation path with a bounded staging ring and a tick thread
that applies the pending batches as one CUDA-graph replay::

    from metrics_tpu_torch.serve import IngestQueue

    q = IngestQueue(collection, capacity=1024, backpressure="block")
    q.enqueue(preds, target)       # host append, no device work
    value = q.compute()            # flush before read: exact
    q.close()                      # drains what is pending

The server, the executable cache and the command line are a later slice.
"""
from metrics_tpu_torch.serve.ingest import (
    IngestBackpressureError,
    IngestQueue,
    active_queues,
    flush_for,
    max_queue_depth,
)

__all__ = ["IngestBackpressureError", "IngestQueue", "active_queues", "flush_for", "max_queue_depth"]
