"""Process-wide counters (counterpart of ``metrics_tpu/obs/registry.py``).

Off by default. Every instrumented path gates its registry write behind one
module-attribute check (``if registry._ENABLED:``), so the disabled path costs an
attribute load and nothing else: no lock, no allocation, no device sync. Counters
count host events: one per checkpoint save or restore, per ingest tick, per update
whose inputs held NaN/Inf rows under ``nan_policy``.

The JAX package also listens to ``jax.monitoring``'s compile events here; the port
has no such events, so it has no listener.
"""
import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator

__all__ = ["REGISTRY", "ObsRegistry", "disable", "enable", "enabled", "observe", "snapshot", "snapshot_json"]

# the one boolean the instrumented paths check; a module attribute, so that the
# disabled cost is one attribute load
_ENABLED: bool = False


class ObsRegistry:
    """Thread-safe counters keyed by ``(scope, name)``: ``scope`` is a metric class
    name or a subsystem (``"ckpt"``, ``"ingest"``), ``name`` the event (``"saves"``,
    ``"ticks"``, ``"nonfinite_rows"``). The JAX package's timers come with the rest
    of the observability slice."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[tuple, float] = {}
        self._recorded = False

    def inc(self, scope: str, name: str, value: float = 1) -> None:
        key = (scope, name)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value
            self._recorded = True

    def get(self, scope: str, name: str, default: float = 0) -> float:
        return self._counters.get((scope, name), default)

    def recorded(self) -> bool:
        """True once a counter was written since the last :meth:`clear`."""
        return self._recorded

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{scope: {name: value}}``."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (scope, name), value in self._counters.items():
                out.setdefault(scope, {})[name] = value
        return out

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
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
