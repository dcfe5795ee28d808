"""metrics_tpu_torch.obs: counters, the flight recorder, health sketches, series and
the Prometheus export (counterpart of ``metrics_tpu/obs``).

    from metrics_tpu_torch import obs

    with obs.observe(clear=True) as reg:
        metric.save_checkpoint("ckpts")
    reg.get("ckpt", "saves")   # 1

    obs.flight.enable(dump_path="/tmp/flight.json", install_handlers=True)
    obs.health.enable()                  # latency sketches on the card
    obs.health.set_slo(p99_ingest_latency_ms=5.0)
    obs.series.enable(interval_s=1.0)    # counter deltas and quantiles, 1 Hz
    obs.prom.start_server(port=9464)     # GET /metrics, GET /healthz
    metric.state_report()                # dtype, shape, bytes, device a state

Off by default: each instrumented path checks one module attribute
(``registry._ENABLED``, then ``flight._RING`` or ``health._MONITOR``), and nothing
is allocated before the surface's own ``enable()``. Not ported yet: flow tracing,
cross-host aggregation, retrace detection, timed scopes, the trace and snapshot
exports and the cost cross-check.
"""
from metrics_tpu_torch.obs import flight, health, prom, registry, ring, series
from metrics_tpu_torch.obs.health import SLOBudget, SLOBudgetExceeded, SLOViolationWarning
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
from metrics_tpu_torch.obs.report import collection_summary, metric_state_report
from metrics_tpu_torch.obs.ring import Ring


def stopwatch(scope: str, name: str = "elapsed"):
    """Shortcut for ``REGISTRY.stopwatch``."""
    return REGISTRY.stopwatch(scope, name)


__all__ = [
    "REGISTRY",
    "ObsRegistry",
    "Ring",
    "SLOBudget",
    "SLOBudgetExceeded",
    "SLOViolationWarning",
    "collection_summary",
    "disable",
    "enable",
    "enabled",
    "flight",
    "health",
    "metric_state_report",
    "observe",
    "prom",
    "registry",
    "ring",
    "series",
    "snapshot",
    "snapshot_json",
    "stopwatch",
]
