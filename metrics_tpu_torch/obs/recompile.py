"""Retrace and recapture storm detection (counterpart of ``metrics_tpu/obs/recompile.py``).

The silent performance fault of a compiled step: a metric fed slightly different
shapes (a ragged last batch, a dtype flip, a Python scalar in place of a tensor) gets
a new step for every signature. In the JAX package that is a retrace and an XLA
compile; in the port it is a new CUDA-graph capture of the fused, fleet or ingest
step (a :class:`~metrics_tpu_torch.core.fused.StepCache` miss) and new per-shape
kernel set-up on the eager path. Nothing warns; the job just runs slower.

Detection is host-side and cheap: every instrumented ``update`` fingerprints the
**abstract** structure of its inputs (nesting, shapes and dtypes under numpy's
names, never values, never a device sync), the same fingerprint the JAX package
takes of the same inputs. A metric instance that accumulates more than one distinct
fingerprint counts ``retraces``; past ``RETRACE_WARN_THRESHOLD`` distinct
fingerprints a warning (once per instance) names the metric and the signatures seen.
The fused engine runs the same check at each step-cache miss.
"""
import threading
import warnings
from typing import Any, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs import flight as _flight
from metrics_tpu_torch.obs import registry as _reg

#: Distinct input fingerprints at which a metric is declared "storming".
RETRACE_WARN_THRESHOLD = 2

#: Distinct fingerprints seen per metric CLASS across all instances. The
#: per-instance dedup below means a fleet of N instances each seeing the same
#: two signatures records N `retraces` but tells you nothing about signature
#: churn at the class level; the `retrace_signatures` counter (one increment
#: per signature beyond the first, class-wide) is what the JSONL export
#: attributes to a class.
_CLASS_FINGERPRINTS: dict = {}

#: Classes already warned about class-level signature churn (once per class).
_CLASS_RETRACE_WARNED: set = set()

#: Guards the class-level maps above: an ingest tick thread can drive instrumented
#: updates while a request thread does, and setdefault + add is not atomic as a
#: sequence.
_CLASS_LOCK = threading.Lock()


def _dtype_name(dtype: Any) -> str:
    """numpy's name of a dtype (``torch.float32`` -> ``"float32"``), as the JAX
    package's fingerprint spells it."""
    return str(dtype).replace("torch.", "")


def _fingerprint_leaf(x: Any) -> Tuple:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), _dtype_name(dtype))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_fingerprint_leaf(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _fingerprint_leaf(x[k])) for k in sorted(map(str, x)))
    if isinstance(x, (bool, int, float, str, bytes, type(None))):
        # static values are part of a step's key, so a varying Python scalar is
        # itself a recapture source: fingerprint the value
        return ("py", type(x).__name__, x)
    return ("obj", type(x).__name__)


def fingerprint(args: Tuple, kwargs: dict) -> Tuple:
    """Abstract (shape/dtype/structure) fingerprint of an update's inputs."""
    return (
        tuple(_fingerprint_leaf(a) for a in args),
        tuple((k, _fingerprint_leaf(kwargs[k])) for k in sorted(kwargs)),
    )


def check_update(metric: Any, args: Tuple, kwargs: dict) -> None:
    """Record one update's input fingerprint on ``metric``; warn on a storm.

    Called from ``Metric``'s update wrapper only when obs is enabled, and by the
    fused engine at a step-cache miss. State lives on the instance
    (``_obs_fingerprints`` / ``_obs_retrace_warned``), so the detector lives as long
    as the metric, with no global id() maps.
    """
    fp = fingerprint(args, kwargs)
    seen = metric.__dict__.get("_obs_fingerprints")
    if seen is None:
        seen = set()
        object.__setattr__(metric, "_obs_fingerprints", seen)
    if fp in seen:
        return
    first = not seen
    seen.add(fp)
    name = type(metric).__name__
    # the class-level map grows only on an instance-level miss (never on the steady
    # state's early return); it changes under a lock, the warning goes out after
    with _CLASS_LOCK:
        class_seen = _CLASS_FINGERPRINTS.setdefault(name, set())
        class_first = not class_seen
        new_signature = fp not in class_seen
        if new_signature:
            class_seen.add(fp)
        n_class = len(class_seen)
        warn_class = (
            new_signature
            and n_class > RETRACE_WARN_THRESHOLD
            and name not in _CLASS_RETRACE_WARNED
            and getattr(metric, "fleet_size", None) is None
        )
        if warn_class:
            _CLASS_RETRACE_WARNED.add(name)
    if new_signature and not class_first:
        _reg.REGISTRY.inc(name, "retrace_signatures")
    if warn_class:
        # class-level churn with per-instance dedup intact means many instances of
        # one class each with their own update: one fleet instance serves them all
        warnings.warn(
            f"metrics_tpu_torch.obs: `{name}` has seen {n_class} distinct"
            " update signatures across its instances (class-wide). If these"
            " are per-stream/per-tenant copies of the same metric, replace"
            f" them with one fleet instance — `{name}(..., fleet_size=N)`"
            " updated via `update(..., stream_ids=...)` — which compiles one"
            " executable and runs one launch for all streams.",
            RuntimeWarning,
            stacklevel=3,
        )
    if not first:
        _reg.REGISTRY.inc(name, "retraces")
        if _flight._RING is not None:
            _flight.record("retrace", metric=name, signatures=len(seen))
    if len(seen) > RETRACE_WARN_THRESHOLD and not metric.__dict__.get("_obs_retrace_warned", False):
        object.__setattr__(metric, "_obs_retrace_warned", True)
        _reg.REGISTRY.inc(name, "retrace_warnings")
        shapes = _summarize(seen)
        warnings.warn(
            f"metrics_tpu_torch.obs: compile storm suspected — `{name}.update` has now seen"
            f" {len(seen)} distinct input shape/dtype signatures ({shapes}). Every new"
            " signature retraces and recompiles the jitted update. Pad inputs to a"
            " fixed shape (or bucket them) to stop the recompilation.",
            RuntimeWarning,
            stacklevel=3,
        )


def _summarize(seen: set, limit: int = 4) -> str:
    def leaf_shapes(fp: Tuple) -> str:
        arrs = [t for t in fp[0] if isinstance(t, tuple) and t and t[0] == "arr"]
        return "/".join("x".join(map(str, t[1])) + f":{t[2]}" for t in arrs) or "<no-arrays>"

    items = sorted(leaf_shapes(fp) for fp in seen)
    head = ", ".join(items[:limit])
    return head + (f", ... +{len(items) - limit} more" if len(items) > limit else "")


def reset_detector(metric: Any) -> None:
    """Forget a metric's fingerprint history (used by tests)."""
    metric.__dict__.pop("_obs_fingerprints", None)
    metric.__dict__.pop("_obs_retrace_warned", None)


def reset_class_detector(name: Any = None) -> None:
    """Forget class-level fingerprint history — all classes, or one class /
    metric class object (used by tests and long-lived eval loops that rotate
    workloads)."""
    with _CLASS_LOCK:
        if name is None:
            _CLASS_FINGERPRINTS.clear()
            _CLASS_RETRACE_WARNED.clear()
            return
        if isinstance(name, type):
            name = name.__name__
        _CLASS_FINGERPRINTS.pop(name, None)
        _CLASS_RETRACE_WARNED.discard(name)


def nbytes_of(x: Any) -> int:
    """Byte size of a tensor or array from its shape and dtype (no device read); 0
    when unknowable."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return 0
    try:
        itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
        return int(np.prod(tuple(shape), dtype=np.int64)) * int(itemsize)
    except Exception:  # noqa: BLE001 — exotic dtypes must not break accounting
        return 0
