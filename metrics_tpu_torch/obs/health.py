"""Self-telemetry: latency quantiles, a device-memory watermark and declarative SLO
budgets (counterpart of ``metrics_tpu/obs/health.py``).

The registry answers "how many"; this module answers "how slow, at what tail". Each
``(op, name)`` latency stream lands in the port's own
:class:`~metrics_tpu_torch.sketches.QuantileSketch` (a few int32 counters under
``sum``, on the device the monitor is given: the card by default), so a week-long
serving job holds the memory of a minute-long one and every quantile carries the
sketch's relative-error certificate.

Observations buffer in Python lists and flush into the sketch in batches of
``flush_every``, each flush one fixed-shape update (a residual flush pads with NaN,
which the sketch counts outside the ranks): two launches of the histogram kernel
a flush. While it flushes, the obs gate is off, so that the self-telemetry never
counts itself. On the card a flush runs on the monitor's own stream, and never from
a thread whose current stream is being captured into a CUDA graph (such a flush
waits in its buffer for the next observation or report).

The memory watermark samples ``torch.cuda.memory_stats(device)
["allocated_bytes.all.current"]`` every ``hbm_sample_every`` observations (None on
the CPU) and keeps the largest, plus any :func:`observe_state_bytes` call.

SLO budgets are declarative: :func:`set_slo` names them, :func:`check_slos`
evaluates them against the registry and the sketches, and reacts by the budget's
``action`` (``"warn"``: :class:`SLOViolationWarning`, ``"raise"``:
:class:`SLOBudgetExceeded`, or a callable given the violations).

Nothing is allocated before :func:`enable`: ``_MONITOR`` stays None, and the
instrumented paths check ``_MONITOR is not None``.
"""
import collections
import sys
import threading
import time
import warnings
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.obs import registry as _reg

__all__ = [
    "HealthMonitor",
    "SLOBudget",
    "SLOBudgetExceeded",
    "SLOViolationWarning",
    "active",
    "check_slos",
    "disable",
    "enable",
    "export_sketches",
    "monitor",
    "observe_state_bytes",
    "report",
    "set_slo",
]

_MONITOR: Optional["HealthMonitor"] = None

#: the ``tm.<op>/...`` scopes whose timed windows feed a sketch (``obs/scopes.py``)
_TRACKED_OPS = ("update", "compute", "forward", "fused")


class SLOViolationWarning(RuntimeWarning):
    """A breached SLO budget (``action="warn"``)."""


class SLOBudgetExceeded(RuntimeError):
    """A breached SLO budget (``action="raise"``)."""


class SLOBudget:
    """One declarative service-level budget (each ceiling None == unchecked).

    Args:
        max_launches_per_step: summed ``dispatches`` counters over ``steps``.
        max_retraces_per_window: ``retraces``/``retrace_signatures`` counters since
            the last check (each check closes a window).
        p99_update_latency_ms: any ``update/<metric>`` sketch's p99.
        max_nonfinite_rows: summed ``nonfinite_rows`` counters (``nan_policy``).
        max_queue_depth: the deepest backlog over the active ingest queues.
        p99_ingest_latency_ms: any ``ingest/<queue>`` sketch's p99 (enqueue to
            applied).
        max_cold_compiles: ``serve.excache.stats()["compiles"]``: kernel builds and
            step captures since the stats were cleared; a prewarmed replica budgets 0.
        p99_flow_latency_ms: any ``flow/...`` sketch's p99.
        action: ``"warn"`` | ``"raise"`` | a callable given the violations.
    """

    def __init__(
        self,
        max_launches_per_step: Optional[float] = None,
        max_retraces_per_window: Optional[int] = None,
        p99_update_latency_ms: Optional[float] = None,
        max_nonfinite_rows: Optional[int] = None,
        max_queue_depth: Optional[int] = None,
        p99_ingest_latency_ms: Optional[float] = None,
        max_cold_compiles: Optional[int] = None,
        p99_flow_latency_ms: Optional[float] = None,
        action: Union[str, Callable[[List[Dict[str, Any]]], None]] = "warn",
    ) -> None:
        if isinstance(action, str) and action not in ("warn", "raise"):
            raise ValueError(f"SLO action must be 'warn', 'raise' or a callable, got {action!r}")
        self.max_launches_per_step = max_launches_per_step
        self.max_retraces_per_window = max_retraces_per_window
        self.p99_update_latency_ms = p99_update_latency_ms
        self.max_nonfinite_rows = max_nonfinite_rows
        self.max_queue_depth = max_queue_depth
        self.p99_ingest_latency_ms = p99_ingest_latency_ms
        self.max_cold_compiles = max_cold_compiles
        self.p99_flow_latency_ms = p99_flow_latency_ms
        self.action = action


def _counter_sum(snap: Dict[str, Dict[str, Any]], *names: str) -> float:
    total = 0.0
    for counters in snap.values():
        for name in names:
            v = counters.get(name)
            if isinstance(v, (int, float)):
                total += v
    return total


class HealthMonitor:
    """Latency sketches, the memory watermark and the SLO state (module docstring).

    Args:
        flush_every: observations a flush folds into a sketch.
        relative_error: the sketches' certified relative accuracy.
        quantiles: the levels reported (0.99 is always added).
        hbm_sample_every: observations between two memory samples.
        device: where the sketches live: ``cuda`` unless the caller names another.
    """

    def __init__(
        self,
        flush_every: int = 256,
        relative_error: float = 0.01,
        quantiles: Tuple[float, ...] = (0.5, 0.9, 0.99),
        hbm_sample_every: int = 64,
        device: Any = None,
    ) -> None:
        from metrics_tpu_torch.utils.data import _resolve_device

        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.device = _resolve_device(device)
        self.flush_every = int(flush_every)
        self.relative_error = float(relative_error)
        self.quantiles = tuple(float(q) for q in quantiles)
        if 0.99 not in self.quantiles:
            self.quantiles = self.quantiles + (0.99,)
        self.hbm_sample_every = int(hbm_sample_every)
        self._lock = threading.RLock()
        # key -> [sketch, state dict, observation count]
        self._sketches: Dict[Tuple[str, str], List[Any]] = {}
        self._buffers: Dict[Tuple[str, str], List[float]] = {}
        #: timed scope windows not yet in a buffer (appended without the lock)
        self._scoped: "collections.deque" = collections.deque()
        self._obs_count = 0
        self.flushes = 0  # sketch updates run (two histogram launches each on the card)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.hbm_watermark_bytes: Optional[int] = None
        self.budget: Optional[SLOBudget] = None
        self._window_base: Dict[str, float] = {}
        self._mark_window()

    # ------------------------------------------------------------ recording

    def observe_scope(self, label: str, seconds: float) -> None:
        """One timed ``tm.*`` window (``obs/scopes.py``): ``tm.update/X`` lands in the
        ``update/X`` sketch, ``tm.fused/step`` in ``fused/step``.

        The window is on the hot path of every update, so it never waits for the
        monitor's lock (a flush on another thread holds it while it launches): it
        goes to a lock-free queue, which the next holder of the lock folds in."""
        if not label.startswith("tm.") or _reg.suppressed():
            return
        op, _, owner = label[3:].partition("/")
        if op not in _TRACKED_OPS:
            return
        self._scoped.append((op, owner or op, seconds * 1e6))
        if len(self._scoped) >= self.flush_every and self._lock.acquire(blocking=False):
            try:
                for key in self._absorb_scoped_locked():
                    if len(self._buffers[key]) >= self.flush_every:
                        self._flush_locked(key)
            finally:
                self._lock.release()

    def _absorb_scoped_locked(self) -> set:
        """Move the queued scope windows into their buffers; returns their keys."""
        keys = set()
        while self._scoped:
            op, name, us = self._scoped.popleft()
            self._buffers.setdefault((op, name), []).append(us)
            keys.add((op, name))
        return keys

    def observe_latency(self, op: str, name: str, seconds: float) -> None:
        """One latency observation of ``op`` on ``name`` (a metric, a queue)."""
        if _reg.suppressed():  # the monitor's own work on this thread
            return
        key = (op, name)
        with self._lock:
            buf = self._buffers.setdefault(key, [])
            buf.append(seconds * 1e6)  # sketched in microseconds
            self._obs_count += 1
            sample_hbm = self._obs_count % self.hbm_sample_every == 0
            if len(buf) >= self.flush_every:
                self._flush_locked(key)
        if sample_hbm:
            self._sample_hbm()

    def _sketch_for(self, key: Tuple[str, str]) -> List[Any]:
        entry = self._sketches.get(key)
        if entry is None:
            from metrics_tpu_torch.sketches import QuantileSketch

            sk = QuantileSketch(
                relative_error=self.relative_error,
                quantiles=self.quantiles,
                min_value=1e-3,  # 1 nanosecond, in microseconds
                device=self.device,
            )
            entry = self._sketches[key] = [sk, sk.init_state(), 0]
        return entry

    def _on_own_stream(self) -> Any:
        return torch.cuda.stream(self._stream) if self._stream is not None else nullcontext()

    def _may_launch(self) -> bool:
        """False on a thread whose current stream is being captured."""
        return self._stream is None or not torch.cuda.is_current_stream_capturing()

    def _flush_locked(self, key: Tuple[str, str]) -> None:
        """Fold one buffered batch into the key's sketch: a fixed shape, NaN-padded,
        recording nothing from this thread (:func:`registry.quiet
        <metrics_tpu_torch.obs.registry.quiet>`); other threads go on recording."""
        buf = self._buffers.get(key)
        if not buf or not self._may_launch():
            return
        while buf:
            batch = buf[: self.flush_every]
            n = len(batch)
            if n < self.flush_every:
                batch = batch + [float("nan")] * (self.flush_every - n)
            del buf[:n]
            entry = self._sketch_for(key)
            sk, state, count = entry
            with _reg.quiet(), self._on_own_stream():
                values = torch.tensor(batch, dtype=torch.float32, device=self.device)
                entry[1] = sk.local_update(state, values)
            entry[2] = count + n
            self.flushes += 1

    def _sample_hbm(self) -> None:
        if self.device.type != "cuda":
            return
        try:
            allocated = torch.cuda.memory_stats(self.device).get("allocated_bytes.all.current")
        except Exception:  # noqa: BLE001 - memory stats are best effort
            allocated = None
        if allocated is not None:
            self.note_hbm(int(allocated))

    def note_hbm(self, nbytes: int) -> None:
        with self._lock:
            if self.hbm_watermark_bytes is None or nbytes > self.hbm_watermark_bytes:
                self.hbm_watermark_bytes = int(nbytes)

    # ------------------------------------------------------------ reporting

    def _flush_all_locked(self) -> None:
        self._absorb_scoped_locked()
        for key in list(self._buffers):
            self._flush_locked(key)

    def report(self) -> Dict[str, Any]:
        """Flush the residuals and return the quantiles and the watermark."""
        with self._lock:
            self._flush_all_locked()
            latency: Dict[str, Any] = {}
            with _reg.quiet(), self._on_own_stream():
                for (op, name), (sk, state, count) in sorted(self._sketches.items()):
                    if count == 0:
                        continue
                    out = sk.compute_from(state)
                    row: Dict[str, Any] = {"count": int(count)}
                    for q, v, c in zip(sk.quantiles, out["quantiles"].tolist(), out["certified"].tolist()):
                        row[f"p{round(q * 100):d}_us"] = round(float(v), 3)
                        row[f"p{round(q * 100):d}_certified"] = bool(c)
                    latency[f"{op}/{name}"] = row
            return {
                "latency_us": latency,
                "hbm_watermark_bytes": self.hbm_watermark_bytes,
                "relative_error": self.relative_error,
                "flush_every": self.flush_every,
            }

    def export_sketches(self) -> Dict[str, Any]:
        """Flush the residuals and export each sketch as mergeable state: its
        parameters and its int32 counters as lists (merged by elementwise addition)."""
        with self._lock:
            self._flush_all_locked()
            out: Dict[str, Any] = {}
            with self._on_own_stream():
                for (op, name), (sk, state, count) in sorted(self._sketches.items()):
                    if count == 0:
                        continue
                    out[f"{op}/{name}"] = {
                        "params": {
                            "relative_error": sk.relative_error,
                            "bits": sk.bits,
                            "min_value": sk.min_value,
                            "quantiles": list(sk.quantiles),
                        },
                        "state": {k: v.tolist() for k, v in state.items()},
                        "count": int(count),
                    }
            return out

    # ------------------------------------------------------------------ SLO

    def _mark_window(self) -> None:
        self._window_base = {"retraces": _counter_sum(_reg.snapshot(), "retraces", "retrace_signatures"),
                             "t": time.time()}

    def _latency_violations(self, prefix: str, slo: str, budget_ms: float, what: str) -> List[Dict[str, Any]]:
        out = []
        for key, row in self.report()["latency_us"].items():
            if not key.startswith(prefix):
                continue
            p99_ms = row.get("p99_us", float("nan")) / 1000.0
            if p99_ms > budget_ms:
                out.append({
                    "slo": slo,
                    "budget": budget_ms,
                    "measured": round(p99_ms, 4),
                    "detail": f"{what} {key.split('/', 1)[1]}"
                    + {"p99_ingest_latency_ms": " enqueue->applied", "p99_flow_latency_ms": " end-to-end"}.get(slo, "")
                    + ("" if row.get("p99_certified") else " (uncertified edge-bin rank)"),
                })
        return out

    def check_slos(self, steps: Optional[int] = None) -> List[Dict[str, Any]]:
        """Evaluate the budget; returns (and reacts to) the violations. Each call
        closes the retrace window."""
        budget = self.budget
        if budget is None:
            return []
        violations: List[Dict[str, Any]] = []
        snap = _reg.snapshot()

        if budget.max_launches_per_step is not None and steps:
            launches = _counter_sum(snap, "dispatches")
            per_step = launches / steps
            if per_step > budget.max_launches_per_step:
                violations.append({
                    "slo": "max_launches_per_step",
                    "budget": budget.max_launches_per_step,
                    "measured": per_step,
                    "detail": f"{launches:.0f} launches over {steps} steps",
                })
        if budget.max_retraces_per_window is not None:
            window = _counter_sum(snap, "retraces", "retrace_signatures") - self._window_base.get("retraces", 0.0)
            if window > budget.max_retraces_per_window:
                violations.append({
                    "slo": "max_retraces_per_window",
                    "budget": budget.max_retraces_per_window,
                    "measured": window,
                    "detail": f"window opened {time.time() - self._window_base['t']:.1f}s ago",
                })
            self._mark_window()
        if budget.max_nonfinite_rows is not None:
            poisoned = _counter_sum(snap, "nonfinite_rows")
            if poisoned > budget.max_nonfinite_rows:
                violations.append({
                    "slo": "max_nonfinite_rows",
                    "budget": budget.max_nonfinite_rows,
                    "measured": poisoned,
                    "detail": "NaN/Inf input rows tallied by nan_policy quarantines",
                })
        if budget.p99_update_latency_ms is not None:
            violations += self._latency_violations("update/", "p99_update_latency_ms", budget.p99_update_latency_ms,
                                                   "metric")
        if budget.p99_ingest_latency_ms is not None:
            violations += self._latency_violations("ingest/", "p99_ingest_latency_ms", budget.p99_ingest_latency_ms,
                                                   "queue")
        if budget.p99_flow_latency_ms is not None:
            violations += self._latency_violations("flow/", "p99_flow_latency_ms", budget.p99_flow_latency_ms, "flow")
        if budget.max_queue_depth is not None:
            # pulled on demand: the ingest tier takes part only once the app imported it
            _ingest = sys.modules.get("metrics_tpu_torch.serve.ingest")
            if _ingest is not None:
                depth = _ingest.max_queue_depth()
                if depth > budget.max_queue_depth:
                    violations.append({
                        "slo": "max_queue_depth",
                        "budget": budget.max_queue_depth,
                        "measured": depth,
                        "detail": "deepest staging backlog across active serve.IngestQueue instances",
                    })
        if budget.max_cold_compiles is not None:
            _excache = sys.modules.get("metrics_tpu_torch.serve.excache")
            if _excache is not None:
                compiles = _excache.stats()["compiles"]
                if compiles > budget.max_cold_compiles:
                    violations.append({
                        "slo": "max_cold_compiles",
                        "budget": budget.max_cold_compiles,
                        "measured": compiles,
                        "detail": "kernel builds and step captures since excache stats were cleared",
                    })
        if violations:
            self._react(budget, violations)
        return violations

    @staticmethod
    def _react(budget: SLOBudget, violations: List[Dict[str, Any]]) -> None:
        if callable(budget.action):
            budget.action(violations)
            return
        msg = "; ".join(
            f"{v['slo']}: measured {v['measured']} > budget {v['budget']} ({v['detail']})" for v in violations
        )
        if budget.action == "raise":
            raise SLOBudgetExceeded(f"metrics_tpu_torch.obs.health SLO breached — {msg}")
        warnings.warn(f"metrics_tpu_torch.obs.health SLO breached — {msg}", SLOViolationWarning, stacklevel=3)


# ----------------------------------------------------------- module facade


def enable(
    flush_every: int = 256,
    relative_error: float = 0.01,
    hbm_sample_every: int = 64,
    enable_obs: bool = True,
    device: Any = None,
) -> HealthMonitor:
    """Allocate and activate the monitor (replacing any previous one); its sketches
    live on ``device``, the card unless the caller names another."""
    global _MONITOR
    _MONITOR = HealthMonitor(
        flush_every=flush_every, relative_error=relative_error, hbm_sample_every=hbm_sample_every, device=device
    )
    if enable_obs:
        _reg.enable()
    return _MONITOR


def disable() -> None:
    global _MONITOR
    _MONITOR = None


def active() -> bool:
    return _MONITOR is not None


def monitor() -> Optional[HealthMonitor]:
    return _MONITOR


def set_slo(**kwargs: Any) -> SLOBudget:
    """Declare the budget on the active monitor (see :class:`SLOBudget`)."""
    if _MONITOR is None:
        raise RuntimeError("obs.health.set_slo requires an enabled monitor (health.enable())")
    budget = kwargs.pop("budget", None)
    if budget is None:
        budget = SLOBudget(**kwargs)
    _MONITOR.budget = budget
    _MONITOR._mark_window()
    return budget


def check_slos(steps: Optional[int] = None) -> List[Dict[str, Any]]:
    return _MONITOR.check_slos(steps=steps) if _MONITOR is not None else []


def report() -> Dict[str, Any]:
    return _MONITOR.report() if _MONITOR is not None else {}


def export_sketches() -> Dict[str, Any]:
    return _MONITOR.export_sketches() if _MONITOR is not None else {}


def observe_state_bytes(metric: Any) -> None:
    """Fold a metric's registered-state bytes into the watermark (the deterministic
    figure where the device keeps no memory statistics, as on the CPU)."""
    if _MONITOR is None:
        return
    try:
        nbytes = metric.state_report()["total_nbytes"]
    except Exception:  # noqa: BLE001
        return
    _MONITOR.note_hbm(int(nbytes))
