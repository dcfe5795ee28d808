"""metrics_tpu_torch.obs: the counters that the checkpoint, ingest and
``nan_policy`` paths write (counterpart of part of ``metrics_tpu/obs``).

    from metrics_tpu_torch import obs

    with obs.observe(clear=True) as reg:
        metric.save_checkpoint("ckpts")
    reg.get("ckpt", "saves")   # 1

Off by default: each instrumented path checks one module attribute
(``registry._ENABLED``). Ported so far: the registry and the bounded :class:`Ring`
the ingest queue stages into. The flight recorder, flow tracing, health monitor,
series, Prometheus export and the hooks that feed them are a later slice of the
port.
"""
from metrics_tpu_torch.obs.registry import (
    REGISTRY,
    ObsRegistry,
    disable,
    enable,
    enabled,
    observe,
    snapshot,
    snapshot_json,
)
from metrics_tpu_torch.obs.ring import Ring

__all__ = ["REGISTRY", "ObsRegistry", "Ring", "disable", "enable", "enabled", "observe", "snapshot", "snapshot_json"]
