"""metrics_tpu_torch.obs: counters, scopes, retrace detection, the flight recorder,
health sketches, flow tracing, series, the exports and cross-host aggregation
(counterpart of ``metrics_tpu/obs``).

    from metrics_tpu_torch import obs

    obs.enable()                         # counters, tm.* ranges, retrace detection
    metric.update(preds, target)         # counted, in a tm.update range, fingerprinted
    obs.snapshot()                       # {"MulticlassAccuracy": {"updates": 1, ...}}
    with obs.trace("/tmp/prof") as path: # a torch.profiler Chrome trace of the block
        eval_step()

    obs.flight.enable(dump_path="/tmp/flight.json", install_handlers=True)
    obs.health.enable()                  # latency sketches on the card
    obs.health.set_slo(p99_ingest_latency_ms=5.0)
    obs.export_chrome_trace("/tmp/tm-trace.json")   # the flight window, for Perfetto

    obs.flow.enable(sample_rate=1)       # flow IDs: enqueue -> tick -> device
    queue.enqueue(preds, target)         # traced end to end, per tenant
    obs.export_spans("/tmp/spans.jsonl") # OTLP-shaped spans

    obs.series.enable(interval_s=1.0)    # counter deltas and quantiles, 1 Hz
    obs.prom.start_server(port=9464)     # GET /metrics, GET /healthz
    obs.aggregate.fleet_snapshot()       # cross-host merge (sketch-exact p99s)
    metric.state_report()                # dtype, shape, bytes, device a state

Off by default: each instrumented path checks one module attribute
(``registry._ENABLED``, then ``flight._RING``, ``health._MONITOR`` or
``flow._TRACER``), and nothing is allocated before the surface's own ``enable()``.
Not ported yet: the cost cross-check (``obs/costcheck.py``: ``costcheck``,
``crosscheck``, ``CostDriftWarning``).
"""
# import order: the ``trace`` submodule binds into the package first; the
# ``from ...scopes import trace`` below then rebinds ``obs.trace`` to the profiler
# capture (the public name, as in the JAX package). The exporter stays reachable as
# ``obs.export_chrome_trace`` and as ``metrics_tpu_torch.obs.trace`` by import.
from metrics_tpu_torch.obs import aggregate, flight, flow, health, prom, recompile, registry, ring, series
from metrics_tpu_torch.obs import trace as _trace_export  # noqa: F401
from metrics_tpu_torch.obs.export import SCHEMA_VERSION, dump_jsonl, validate_snapshot
from metrics_tpu_torch.obs.export import snapshot as export_snapshot
from metrics_tpu_torch.obs.flow import export_spans, validate_spans
from metrics_tpu_torch.obs.health import SLOBudget, SLOBudgetExceeded, SLOViolationWarning
from metrics_tpu_torch.obs.recompile import RETRACE_WARN_THRESHOLD, fingerprint, reset_class_detector, reset_detector
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
from metrics_tpu_torch.obs.scopes import annotate, compute_scope, forward_scope, sync_scope, trace, update_scope
from metrics_tpu_torch.obs.trace import chrome_trace_events, export_chrome_trace, validate_chrome_trace


def stopwatch(scope: str, name: str = "elapsed"):
    """Shortcut for ``REGISTRY.stopwatch``."""
    return REGISTRY.stopwatch(scope, name)


__all__ = [
    "REGISTRY",
    "RETRACE_WARN_THRESHOLD",
    "SCHEMA_VERSION",
    "ObsRegistry",
    "Ring",
    "SLOBudget",
    "SLOBudgetExceeded",
    "SLOViolationWarning",
    "aggregate",
    "annotate",
    "chrome_trace_events",
    "collection_summary",
    "compute_scope",
    "disable",
    "dump_jsonl",
    "enable",
    "enabled",
    "export_chrome_trace",
    "export_snapshot",
    "export_spans",
    "fingerprint",
    "flight",
    "flow",
    "forward_scope",
    "health",
    "metric_state_report",
    "observe",
    "prom",
    "recompile",
    "registry",
    "reset_class_detector",
    "reset_detector",
    "ring",
    "series",
    "snapshot",
    "snapshot_json",
    "stopwatch",
    "sync_scope",
    "trace",
    "update_scope",
    "validate_chrome_trace",
    "validate_snapshot",
    "validate_spans",
]
