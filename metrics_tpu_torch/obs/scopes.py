"""Named trace scopes: make ``torch.profiler`` traces attribute host windows and
device work to metrics (counterpart of ``metrics_tpu/obs/scopes.py``).

Every scope is a ``torch.profiler.record_function`` range: in a profiler trace the
range holds the host window, and the kernels launched inside it are correlated to it.
Naming convention, the JAX package's:

    tm.update/<MetricClassName>     one metric update
    tm.compute/<MetricClassName>    one metric compute
    tm.forward/<MetricClassName>    dual-purpose forward
    tm.collection.update            MetricCollection fan-out
    tm.fused/step                   one fused step (a CUDA-graph replay on the card)
    tm.sync/<reduce_fx>             one collective state sync
    tm.rank/<tier>                  one rank-engine dispatch (ops/rank.py)

Callers in the hot path check ``registry._ENABLED`` *before* they build the context
manager, so the disabled path never allocates one. A range opened on a thread that is
capturing a CUDA graph is host bookkeeping only: nothing of it lands in the graph.
``trace(path)`` is the one-call capture around ``torch.profiler.profile``.
"""
import os
import time
from contextlib import contextmanager
from typing import Iterator

import torch

from metrics_tpu_torch.obs import flight as _flight
from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _reg

__all__ = ["annotate", "compute_scope", "forward_scope", "sync_scope", "trace", "update_scope"]


@contextmanager
def annotate(label: str) -> Iterator[None]:
    """Enter ``torch.profiler.record_function(label)`` while a profiler runs.

    Also counts the entry under ``("scopes", label)``, so that tests and exported
    snapshots can tell which ranges a run opened without parsing a trace. While the
    flight recorder or the health monitor is on, the window is timed as well (two
    ``perf_counter`` reads): the flight ring gets a ``scope`` event, which the Chrome
    trace export renders as a slice, and the health sketches get the latency.
    """
    _reg.REGISTRY.inc("scopes", label)
    timed = _flight._RING is not None or _health._MONITOR is not None
    t0 = time.perf_counter() if timed else 0.0
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(label):
            yield
    else:  # no profiler to see the range: skip its ~10 us of dispatcher calls
        yield
    if timed:
        dt = time.perf_counter() - t0
        if _flight._RING is not None:
            _flight.record("scope", ts_us=t0 * 1e6, name=label, dur_us=dt * 1e6)
        monitor = _health._MONITOR
        if monitor is not None:
            monitor.observe_scope(label, dt)


def update_scope(metric_name: str):
    return annotate(f"tm.update/{metric_name}")


def compute_scope(metric_name: str):
    return annotate(f"tm.compute/{metric_name}")


def forward_scope(metric_name: str):
    return annotate(f"tm.forward/{metric_name}")


def sync_scope(reduce_fx) -> "annotate":
    kind = reduce_fx if isinstance(reduce_fx, str) else (
        "stack" if reduce_fx is None else getattr(reduce_fx, "__name__", "custom")
    )
    return annotate(f"tm.sync/{kind}")


@contextmanager
def trace(path: str, enable_obs: bool = True) -> Iterator[str]:
    """One-call profile capture: ``with obs.trace("/tmp/prof") as file: eval_step()``.

    Runs ``torch.profiler.profile`` over the block, with CUDA activities when a card
    is present, and writes its Chrome trace to ``<path>/tm-trace-<pid>.json``; yields
    that file's path. By default the obs gate is on for the block, so that the trace
    holds the ``tm.*`` ranges.
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"tm-trace-{os.getpid()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prev = _reg.enabled()
    if enable_obs:
        _reg.enable()
    try:
        with profile(activities=activities) as prof:
            yield out
        prof.export_chrome_trace(out)
    finally:
        if enable_obs and not prev:
            _reg.disable()
