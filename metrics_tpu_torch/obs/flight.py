"""Flight recorder: a bounded ring of structured runtime events, dumped on failure
(counterpart of ``metrics_tpu/obs/flight.py``).

A job that dies on a preempted machine leaves an exit code; what matters (the last
fused replay, whether the checkpoint committed) needs the last few hundred runtime
events. The recorder keeps them in a fixed-capacity :class:`~metrics_tpu_torch.obs.ring.Ring`
appended to by the instrumented paths, and :func:`dump` writes the surviving window,
with ``state_report()`` snapshots of recently checkpointed metrics, as one JSON file.

Event kinds the runtime emits (all behind the obs gate):

    ``dispatch``          one eager metric update (metric, input shapes and dtypes)
    ``merge``             one ``merge_state``
    ``nonfinite_inputs``  rows a ``nan_policy`` quarantine counted
    ``fused_cache_miss``  the fused engine captured a new step
    ``fused_launch``      one fused-collection replay (groups, cache key digest)
    ``fleet_route``       one routed or broadcast fleet batch (rows, streams)
    ``ingest_tick``       one ingest tick (entries, rows, replays)
    ``degrade``           a step that left the fused path (site, error)
    ``fault``             an injected fault that fired
    ``excache_prewarm``   one warm-manifest replay (entries, captured, seconds)
    ``ckpt_save_begin`` / ``ckpt_save_commit`` / ``ckpt_save_retry`` / ``ckpt_restore``
    ``server_state`` / ``server_slo`` / ``drift_alert``   the metrics server

Gate: every call site sits inside an ``if registry._ENABLED:`` block and checks
``flight._RING is not None``; no ring exists until :func:`enable`.

Dump on failure: :func:`enable` can install an ``atexit`` hook, chaining signal
handlers (SIGTERM by default) and a chaining ``sys.excepthook``; each writes the
window before the process dies, then hands over to what was installed before (or
re-delivers the signal with its default action, so the exit status stays honest).
``ckpt_integration`` writes the window into each checkpoint's temporary directory,
committed by the same rename as the checkpoint.
"""
import atexit
import itertools
import json
import os
import signal as _signal
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.obs import registry as _reg
from metrics_tpu_torch.obs.ring import Ring

__all__ = [
    "DUMP_SCHEMA_VERSION",
    "active",
    "capacity",
    "ckpt_integration_active",
    "clear",
    "disable",
    "dump",
    "enable",
    "events",
    "failure_dump_path",
    "last",
    "note_state_source",
    "record",
    "record_dispatch",
]

#: schema stamp of the dump file; the JAX package's dumps are version 2 as well
DUMP_SCHEMA_VERSION = 2

#: the ring; None == recorder off == nothing allocated
_RING: Optional[Ring] = None

_SEQ = itertools.count()
_LOCK = threading.Lock()

_DUMP_PATH: Optional[str] = None
_CKPT_INTEGRATION: bool = False
_CAPACITY: int = 0

#: weak references to the objects whose state report rides every dump
_STATE_SOURCES: "List[weakref.ref]" = []

_PREV_HANDLERS: Dict[int, Any] = {}
_ATEXIT_REGISTERED = False
#: the ``sys.excepthook`` in place before ours (None == ours not installed)
_PREV_EXCEPTHOOK: Optional[Any] = None


def _now_us() -> float:
    return time.perf_counter() * 1e6


def enable(
    capacity: int = 512,
    dump_path: Optional[str] = None,
    install_handlers: bool = False,
    signals: Tuple[int, ...] = (_signal.SIGTERM,),
    ckpt_integration: bool = False,
    enable_obs: bool = True,
) -> None:
    """Allocate the ring and start recording.

    Args:
        capacity: events kept (the "last K" of every dump).
        dump_path: where failure dumps go; required for ``install_handlers``.
        install_handlers: register the ``atexit`` hook, chaining handlers on
            ``signals`` and a chaining ``sys.excepthook``, each writing a dump.
        signals: the signals to hook (SIGTERM, the preemption notice, by default).
        ckpt_integration: every ``save_checkpoint`` also writes the window as
            ``flight-h<rank>.json`` into the step directory before its commit.
        enable_obs: flight events come only from obs-gated sites, so the gate is
            turned on too by default.
    """
    global _RING, _DUMP_PATH, _CKPT_INTEGRATION, _CAPACITY
    if capacity < 1:
        raise ValueError(f"flight recorder capacity must be >= 1, got {capacity}")
    with _LOCK:
        _RING = Ring(capacity)
        _CAPACITY = capacity
        _DUMP_PATH = dump_path
        _CKPT_INTEGRATION = bool(ckpt_integration)
    if enable_obs:
        from metrics_tpu_torch.obs import registry as _reg

        _reg.enable()
    if install_handlers:
        if dump_path is None:
            raise ValueError("install_handlers=True requires dump_path")
        _install_handlers(signals)


def disable() -> None:
    """Stop recording, free the ring and uninstall the failure handlers."""
    global _RING, _DUMP_PATH, _CKPT_INTEGRATION
    _uninstall_handlers()
    with _LOCK:
        _RING = None
        _DUMP_PATH = None
        _CKPT_INTEGRATION = False
        _STATE_SOURCES.clear()


def active() -> bool:
    return _RING is not None


def ckpt_integration_active() -> bool:
    return _RING is not None and _CKPT_INTEGRATION


def capacity() -> int:
    return _CAPACITY if _RING is not None else 0


# -------------------------------------------------------------- recording


def record(kind: str, ts_us: Optional[float] = None, **fields: Any) -> None:
    """Append one event ``{seq, ts_us, kind, **fields}``; a no-op when off. ``seq`` is
    a process-wide monotone counter, ``ts_us`` the ``perf_counter`` microseconds."""
    ring = _RING
    if ring is None or _reg.suppressed():
        return
    event = {"seq": next(_SEQ), "ts_us": _now_us() if ts_us is None else ts_us, "kind": kind}
    event.update(fields)
    ring.append(event)


def _shape_str(x: Any) -> str:
    """``"64x3:float32"`` for a tensor or array (its ``torch.dtype`` or numpy dtype
    name), the value for a Python scalar, else the type's name."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return "x".join(map(str, tuple(shape))) + ":" + str(dtype).replace("torch.", "")
    if isinstance(x, (bool, int, float)):
        return f"py:{type(x).__name__}={x}"
    return type(x).__name__


def record_dispatch(metric_name: str, args: Tuple, kwargs: Dict, flow_id: Optional[str] = None) -> None:
    """One eager update, its inputs summarized by shape and dtype (never values)."""
    if _RING is None:
        return
    shapes = [_shape_str(a) for a in args]
    shapes += [f"{k}={_shape_str(v)}" for k, v in kwargs.items()]
    if flow_id is None:
        record("dispatch", metric=metric_name, avals=shapes)
    else:
        record("dispatch", metric=metric_name, avals=shapes, flow_id=flow_id)


def events() -> List[Dict[str, Any]]:
    """The current window, oldest first."""
    ring = _RING
    if ring is None:
        return []
    return ring.snapshot()


def last(k: int) -> List[Dict[str, Any]]:
    return events()[-k:]


def clear() -> None:
    ring = _RING
    if ring is not None:
        ring.clear()


# ------------------------------------------------------- state-report riders


def note_state_source(obj: Any) -> None:
    """Remember ``obj`` (weakly; the 8 newest) so that its state report rides dumps."""
    if _RING is None:
        return
    with _LOCK:
        refs = [r for r in _STATE_SOURCES if r() is not None and r() is not obj]
        refs.append(weakref.ref(obj))
        del _STATE_SOURCES[:]
        _STATE_SOURCES.extend(refs[-8:])


def _report_of(obj: Any) -> Optional[Dict[str, Any]]:
    if hasattr(obj, "state_report"):
        return obj.state_report()
    if hasattr(obj, "summary"):
        return obj.summary()
    return None


def _state_reports() -> List[Dict[str, Any]]:
    """The registered sources' reports, never blocking: a dump from a signal handler
    may interrupt a thread inside :func:`note_state_source` holding ``_LOCK``, so the
    lock is only tried, and on contention the list is read without it (it holds weak
    references: a torn read costs one rider at most)."""
    if _LOCK.acquire(blocking=False):
        try:
            objs = [r() for r in _STATE_SOURCES]
        finally:
            _LOCK.release()
    else:
        objs = [r() for r in list(_STATE_SOURCES)]
    out = []
    for obj in objs:
        if obj is None:
            continue
        try:
            report = _report_of(obj)
        except Exception:  # noqa: BLE001 - a post-mortem never raises
            continue
        if report is not None:
            out.append(report)
    return out


# --------------------------------------------------------------------- dump


def dump(path: Optional[str] = None, state_objs: Optional[List[Any]] = None) -> Optional[str]:
    """Write the window as one JSON file (atomically); returns the path, or None when
    the recorder is off, no path is known or the write failed."""
    path = path or _DUMP_PATH
    ring = _RING
    if ring is None or path is None:
        return None
    reports = _state_reports()
    for obj in state_objs or ():
        try:
            report = _report_of(obj)
        except Exception:  # noqa: BLE001
            continue
        if report is not None:
            reports.append(report)
    payload = {
        "schema_version": DUMP_SCHEMA_VERSION,
        "dumped_unix": time.time(),
        "anchor_us": _now_us(),
        "capacity": _CAPACITY,
        "events": events(),
        "state_reports": reports,
    }
    try:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, default=str)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 - a failing dump must not mask the failure
        return None


# -------------------------------------------------------- failure handlers


def failure_dump_path() -> Optional[str]:
    """Where the failure handlers write: ``dump_path`` suffixed with the process's
    rank and pid (``...-h0000-p12345.json``), so that processes sharing a directory
    never overwrite each other. :func:`dump` keeps an explicit path as it is."""
    if _DUMP_PATH is None:
        return None
    try:
        from metrics_tpu_torch.parallel.collective import process_topology

        rank, _ = process_topology()
    except Exception:  # noqa: BLE001 - mid-failure, a best-effort name beats none
        rank = 0
    root, ext = os.path.splitext(_DUMP_PATH)
    return f"{root}-h{rank:04d}-p{os.getpid()}{ext or '.json'}"


def _on_exit() -> None:
    if _RING is not None and _DUMP_PATH is not None:
        dump(failure_dump_path())


def _on_signal(signum: int, frame: Any) -> None:
    dump(failure_dump_path())
    prev = _PREV_HANDLERS.get(signum)
    if callable(prev):
        prev(signum, frame)
        return
    # the previous handler was the default (or SIG_IGN): restore it and re-deliver,
    # so that the process ends with the signal's own exit status
    _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _on_unhandled(exc_type: Any, exc: Any, tb: Any) -> None:
    """Chaining ``sys.excepthook``: record the exception, dump, hand over."""
    try:
        if _RING is not None:
            record(
                "unhandled_exception",
                exc_type=getattr(exc_type, "__name__", str(exc_type)),
                message=str(exc)[:200],
            )
            dump(failure_dump_path())
    except Exception:  # noqa: BLE001 - the hook must never mask the failure
        pass
    prev = _PREV_EXCEPTHOOK
    (prev if callable(prev) else sys.__excepthook__)(exc_type, exc, tb)


def _install_handlers(signals: Tuple[int, ...]) -> None:
    global _ATEXIT_REGISTERED, _PREV_EXCEPTHOOK
    if not _ATEXIT_REGISTERED:
        atexit.register(_on_exit)
        _ATEXIT_REGISTERED = True
    if _PREV_EXCEPTHOOK is None:
        _PREV_EXCEPTHOOK = sys.excepthook
        sys.excepthook = _on_unhandled
    for signum in signals:
        if signum in _PREV_HANDLERS:
            continue
        try:
            _PREV_HANDLERS[signum] = _signal.signal(signum, _on_signal)
        except (ValueError, OSError):  # not the main thread, or an unsupported signal
            continue


def _uninstall_handlers() -> None:
    global _PREV_EXCEPTHOOK
    if _PREV_EXCEPTHOOK is not None:
        # restored only if nobody chained on top of ours meanwhile
        if sys.excepthook is _on_unhandled:
            sys.excepthook = _PREV_EXCEPTHOOK
        _PREV_EXCEPTHOOK = None
    for signum, prev in list(_PREV_HANDLERS.items()):
        try:
            _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        _PREV_HANDLERS.pop(signum, None)
