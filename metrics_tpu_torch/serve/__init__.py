"""metrics_tpu_torch.serve: the serving path (counterpart of ``metrics_tpu/serve``).

The async ingestion tier (:mod:`~metrics_tpu_torch.serve.ingest`) takes batch
arrival off the accumulation path with a bounded staging ring and a tick thread
that applies the pending batches as one CUDA-graph replay::

    from metrics_tpu_torch.serve import IngestQueue

    q = IngestQueue(collection, capacity=1024, backpressure="block")
    q.enqueue(preds, target)       # host append, no device work
    value = q.compute()            # flush before read: exact
    q.close()                      # drains what is pending

The executable cache (:mod:`~metrics_tpu_torch.serve.excache`) makes a restart free
of cold captures: a persistent kernel-library directory, and a warm manifest of the
engines' step keys that ``prewarm`` captures before the first request::

    from metrics_tpu_torch.serve import excache

    excache.enable_persistent_cache("/var/cache/metrics_tpu_torch/kernels")
    excache.enable_recording()     # step-cache misses land in the manifest
    ...                            # a checkpoint writes warm_manifest.json beside it
    excache.prewarm(queue, "ckpts/warm_manifest.json")   # at the restart

The server (:mod:`~metrics_tpu_torch.serve.server`, ``python -m
metrics_tpu_torch.serve``) composes both, with checkpoints, fault sites and the obs
stack, into one deployable process: N named collections from a declarative config,
one fair shared ticker, restore-prewarm-ready startup and drain-checkpoint-stop
shutdown::

    from metrics_tpu_torch.serve import MetricsServer, load_config

    with MetricsServer(load_config("serve.json")) as server:
        server.enqueue("quality", preds, target, stream_ids=ids)
        value = server.compute("quality")
"""
from metrics_tpu_torch.serve import excache
from metrics_tpu_torch.serve.excache import enable_persistent_cache, enable_recording, prewarm, save_manifest
from metrics_tpu_torch.serve.ingest import (
    IngestBackpressureError,
    IngestQueue,
    active_queues,
    flush_for,
    max_queue_depth,
)
from metrics_tpu_torch.serve.server import (
    CollectionSpec,
    DriftAlert,
    DriftAlertError,
    MetricsServer,
    ServerConfig,
    ServerConfigError,
    ServerStateError,
    load_config,
)

__all__ = [
    "CollectionSpec",
    "DriftAlert",
    "DriftAlertError",
    "IngestBackpressureError",
    "IngestQueue",
    "MetricsServer",
    "ServerConfig",
    "ServerConfigError",
    "ServerStateError",
    "active_queues",
    "excache",
    "enable_persistent_cache",
    "enable_recording",
    "flush_for",
    "load_config",
    "max_queue_depth",
    "prewarm",
    "save_manifest",
]
