"""Continuous telemetry series: a background sampler over the obs registry
(counterpart of ``metrics_tpu/obs/series.py``).

Every ``interval_s`` a daemon thread takes the registry's counter **deltas** (what
happened since the previous tick), the timer deltas and the health monitor's
quantiles and watermark into a fixed-capacity ring of ticks, and evaluates
:func:`metrics_tpu_torch.obs.health.check_slos`, so that the SLOs are checked
continuously instead of where a caller asks.

Tick layout (one dict a tick, oldest first in :func:`ticks`)::

    {"t_unix": ..., "dt_s": ...,            # wall anchor and the tick's width
     "counters": {scope: {name: delta}},
     "timers":   {scope: {name: {count, total_s}}},
     "latency_us": {...},                   # health.report()["latency_us"]
     "hbm_watermark_bytes": ...,            # None without a monitor
     "slo_violations": [...]}               # check_slos() of this tick

Nothing exists before :func:`enable` (``_SAMPLER`` is None), and no instrumented
path calls into this module: the sampler pulls. The health report it reads flushes
with the obs gate off, so sampling never counts itself.
"""
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _reg

__all__ = ["TelemetrySampler", "active", "disable", "enable", "sampler", "ticks"]

_SAMPLER: Optional["TelemetrySampler"] = None


def _flatten(snap: Dict[str, Dict[str, Any]]) -> Dict[Tuple[str, str], Any]:
    """``{scope: {name: value}}`` -> ``{(scope, name): value}``."""
    flat: Dict[Tuple[str, str], Any] = {}
    for scope, counters in snap.items():
        for name, value in counters.items():
            flat[(scope, name)] = value
    return flat


class TelemetrySampler:
    """Fixed-capacity ring of periodic registry and health ticks.

    Args:
        interval_s: seconds between ticks.
        capacity: ticks kept (600 at 1 Hz: ten minutes).
        check_slos: evaluate the health budget at every tick (the violations land
            in the tick and the budget's action reacts).
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        capacity: int = 600,
        check_slos: bool = True,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.check_slos = bool(check_slos)
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_flat = _flatten(_reg.snapshot())
        self._prev_t = time.time()
        self.ticks_taken = 0
        self.slo_violations_total = 0

    # ------------------------------------------------------------- sampling

    def tick(self) -> Dict[str, Any]:
        """Take one sample now (the thread's work; a test calls it directly).
        Returns the tick appended."""
        now = time.time()
        snap_flat = _flatten(_reg.snapshot())
        counters: Dict[str, Dict[str, float]] = {}
        timers: Dict[str, Dict[str, Dict[str, float]]] = {}
        for key, value in snap_flat.items():
            scope, name = key
            prev = self._prev_flat.get(key)
            if isinstance(value, dict):
                prev = prev if isinstance(prev, dict) else {}
                d_count = value.get("count", 0) - prev.get("count", 0)
                if d_count:
                    timers.setdefault(scope, {})[name] = {
                        "count": d_count,
                        "total_s": value.get("total_s", 0.0) - prev.get("total_s", 0.0),
                    }
            else:
                delta = value - (prev if isinstance(prev, (int, float)) else 0)
                if delta:
                    counters.setdefault(scope, {})[name] = delta

        monitor = _health._MONITOR
        latency: Dict[str, Any] = {}
        hbm: Optional[int] = None
        violations: List[Dict[str, Any]] = []
        if monitor is not None:
            health_report = monitor.report()
            latency = health_report["latency_us"]
            hbm = health_report["hbm_watermark_bytes"]
            if self.check_slos:
                violations = monitor.check_slos()

        tick = {
            "t_unix": now,
            "dt_s": now - self._prev_t,
            "counters": counters,
            "timers": timers,
            "latency_us": latency,
            "hbm_watermark_bytes": hbm,
            "slo_violations": violations,
        }
        with self._lock:
            self._ring.append(tick)
            self._prev_flat = snap_flat
            self._prev_t = now
            self.ticks_taken += 1
            self.slo_violations_total += len(violations)
        return tick

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - telemetry never kills the host
                continue

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="tmscope-sampler", daemon=True
        )
        self._thread.start()

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=join_timeout_s)
            self._thread = None

    # ------------------------------------------------------------ reporting

    def ticks(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The ticks, oldest first (the last ``last`` of them when given)."""
        with self._lock:
            out = list(self._ring)
        return out if last is None else out[-last:]

    def series(self, scope: str, name: str) -> List[Tuple[float, float]]:
        """One counter's deltas as ``[(t_unix, delta), ...]``, zeros included."""
        out = []
        for tick in self.ticks():
            out.append((tick["t_unix"], float(tick["counters"].get(scope, {}).get(name, 0))))
        return out

    def rates(self) -> Dict[str, Dict[str, float]]:
        """Per-second counter rates of the newest tick (empty before the first; a
        zero-width tick gives the raw deltas)."""
        last = self.ticks(last=1)
        if not last:
            return {}
        tick = last[0]
        dt = tick["dt_s"] if tick["dt_s"] > 0 else 1.0
        return {
            scope: {name: delta / dt for name, delta in counters.items()}
            for scope, counters in tick["counters"].items()
        }


# ----------------------------------------------------------- module facade


def enable(
    interval_s: float = 1.0,
    capacity: int = 600,
    check_slos: bool = True,
    start_thread: bool = True,
    enable_obs: bool = True,
) -> TelemetrySampler:
    """Allocate and start the sampler (replacing any previous one).
    ``start_thread=False`` leaves the ticking to explicit
    :meth:`TelemetrySampler.tick` calls."""
    global _SAMPLER
    disable()
    sampler = TelemetrySampler(
        interval_s=interval_s, capacity=capacity, check_slos=check_slos
    )
    _SAMPLER = sampler
    if enable_obs:
        _reg.enable()
    if start_thread:
        sampler.start()
    return sampler


def disable() -> None:
    """Stop the thread and free the ring."""
    global _SAMPLER
    sampler = _SAMPLER
    _SAMPLER = None
    if sampler is not None:
        sampler.stop()


def active() -> bool:
    return _SAMPLER is not None


def sampler() -> Optional[TelemetrySampler]:
    return _SAMPLER


def ticks(last: Optional[int] = None) -> List[Dict[str, Any]]:
    return _SAMPLER.ticks(last=last) if _SAMPLER is not None else []
