"""Process-wide counters (counterpart of ``metrics_tpu/obs/registry.py``).

Off by default. Every instrumented path gates its registry write behind one
module-attribute check (``if registry._ENABLED:``), so the disabled path costs an
attribute load and nothing else: no lock, no allocation, no device sync. Counters
count host events: one per checkpoint save or restore, per ingest tick, per update
whose inputs held NaN/Inf rows under ``nan_policy``.

:func:`quiet` keeps one thread's own records out (the health monitor's sketch
flushes, which may run on a request or tick thread) while every other thread goes on
recording: the gate itself is never turned off for that.

The JAX package also listens to ``jax.monitoring``'s compile events here; the port
has no such events, so it has no listener.
"""
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator

__all__ = [
    "REGISTRY", "ObsRegistry", "disable", "enable", "enabled", "observe", "quiet", "snapshot", "snapshot_json", "suppressed",
]

# the one boolean the instrumented paths check; a module attribute, so that the
# disabled cost is one attribute load
_ENABLED: bool = False

# per thread: inside quiet(), this thread's counters, timers and flight events drop
_LOCAL = threading.local()


def suppressed() -> bool:
    """True on a thread inside :func:`quiet`."""
    return getattr(_LOCAL, "quiet", False)


@contextmanager
def quiet() -> Iterator[None]:
    """Record nothing from this thread meanwhile; other threads record as before."""
    prev = getattr(_LOCAL, "quiet", False)
    _LOCAL.quiet = True
    try:
        yield
    finally:
        _LOCAL.quiet = prev


class _Stopwatch:
    """What :meth:`ObsRegistry.stopwatch` yields: ``elapsed`` seconds, set on exit."""

    __slots__ = ("elapsed", "_t0")

    def __init__(self) -> None:
        self.elapsed: float = 0.0
        self._t0: float = 0.0


class ObsRegistry:
    """Thread-safe counters and timers keyed by ``(scope, name)``: ``scope`` is a
    metric class name or a subsystem (``"ckpt"``, ``"ingest"``, ``"server"``),
    ``name`` the event (``"saves"``, ``"ticks"``, ``"nonfinite_rows"``). A timer
    keeps ``{count, total_s, max_s}``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[tuple, float] = {}
        self._timers: Dict[tuple, Dict[str, float]] = {}
        self._recorded = False

    def inc(self, scope: str, name: str, value: float = 1) -> None:
        if getattr(_LOCAL, "quiet", False):
            return
        key = (scope, name)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value
            self._recorded = True

    def get(self, scope: str, name: str, default: float = 0) -> float:
        return self._counters.get((scope, name), default)

    def observe_duration(self, scope: str, name: str, seconds: float) -> None:
        if getattr(_LOCAL, "quiet", False):
            return
        key = (scope, name)
        with self._lock:
            t = self._timers.setdefault(key, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)
            self._recorded = True

    @contextmanager
    def stopwatch(self, scope: str, name: str) -> Iterator[_Stopwatch]:
        """Always measures the wall time (``sw.elapsed``); records it only while the
        gate is on."""
        sw = _Stopwatch()
        sw._t0 = time.perf_counter()
        try:
            yield sw
        finally:
            sw.elapsed = time.perf_counter() - sw._t0
            if _ENABLED:
                self.observe_duration(scope, name, sw.elapsed)

    def recorded(self) -> bool:
        """True once a counter was written since the last :meth:`clear`."""
        return self._recorded

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{scope: {name: value}}``; a timer as ``{count, total_s, max_s}``."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (scope, name), value in self._counters.items():
                out.setdefault(scope, {})[name] = value
            for (scope, name), t in self._timers.items():
                out.setdefault(scope, {})[name] = dict(t)
        return out

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._recorded = False


#: the process-wide registry the instrumented paths write into
REGISTRY = ObsRegistry()


def enable(clear: bool = False) -> None:
    """Turn the counters on."""
    global _ENABLED
    if clear:
        REGISTRY.clear()
    _ENABLED = True


def disable() -> None:
    """Back to the default: nothing recorded."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


@contextmanager
def observe(clear: bool = False) -> Iterator[ObsRegistry]:
    """Scoped :func:`enable`: restores the previous state on exit."""
    global _ENABLED
    prev = _ENABLED
    enable(clear=clear)
    try:
        yield REGISTRY
    finally:
        _ENABLED = prev


def snapshot() -> Dict[str, Dict[str, Any]]:
    return REGISTRY.snapshot()


def snapshot_json() -> str:
    return json.dumps(REGISTRY.snapshot(), sort_keys=True)
