"""Restart without cold captures: a persistent kernel-library directory and a warm
manifest that captures the engines' steps before the first request (counterpart of
``metrics_tpu/serve/excache.py``, in its torch meaning).

A fresh replica of the JAX package pays its traces and XLA compiles before its first
request; the port pays its kernel builds (``nvcc``) and its CUDA-graph captures (a
``gc.collect``, a warm-up step and the capture, 50 to 300 ms each on the card). A
CUDA graph cannot be written to disk, so the two layers become:

- **Persistent kernel directory** (:func:`enable_persistent_cache`): the hand-written
  kernels are built into, and loaded from, the given directory
  (``metrics_tpu_torch._build.BUILD_DIR``), so a restarted replica finds its
  libraries built. :func:`stats` then counts ``disk_hits`` (a library found built: no
  ``nvcc``) and ``compiles``: every build while the directory is set, that is every
  ``nvcc`` run and every step-cache miss that builds a step (a capture on the card,
  the eager step on the CPU).
- **Warm manifest** (:func:`enable_recording`, :func:`prewarm`): every step-cache
  miss of the fused engine, the fleet and the ingest queue's chain records a stable
  digest of its key (:func:`~metrics_tpu_torch.core.fused.stable_key_digest`, free of
  ``hash()`` salting and ``id()``) and a spec that rebuilds its inputs (shapes,
  dtypes and static leaves). The checkpoint manager writes it as
  ``warm_manifest.json`` beside every checkpoint while recording is on.
  :func:`prewarm` rebuilds each entry's step and captures it into the owning step
  cache before the server is ready, so the first real request makes no capture. A
  capture runs its warm-up step, so prewarm captures on the capture's own copies of
  the states, with zero inputs of the recorded shapes and dtypes (zeros are in range
  for every id input); the live states enter the graph's buffers at its first replay.

Degradation: prewarm never fails startup. Schema drift, a stale stamp (the torch
version, the CUDA version and the device name it was recorded under), an entry of
an engine the port keeps no cache for (the JAX package's ``rank`` entries) and an
injected ``excache.prewarm`` fault each warn and skip their entry (or the manifest),
whose step then captures lazily at first use, bit-identically.

The engines look this module up in ``sys.modules`` at a miss only, so a process that
never imports it pays nothing on the steady path.
"""
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch import _build
from metrics_tpu_torch.core import fused as _fused
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import flight as _obs_flight
from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.utils.exceptions import MetricsUserWarning

__all__ = [
    "MANIFEST_NAME",
    "SCHEMA_VERSION",
    "cache_dir",
    "clear_manifest",
    "clear_stats",
    "disable_persistent_cache",
    "disable_recording",
    "enable_persistent_cache",
    "enable_recording",
    "last_prewarm",
    "load_manifest",
    "manifest_entries",
    "manifest_payload",
    "prewarm",
    "recording",
    "save_manifest",
    "stats",
]

#: manifest file name, written beside checkpoints by the checkpoint manager
MANIFEST_NAME = "warm_manifest.json"

#: bumped on any incompatible change to the entry encoding
SCHEMA_VERSION = 1

_LOCK = threading.Lock()

#: the persistent kernel directory (None == off) and the build directory it replaced
_CACHE_DIR: Optional[str] = None
_DEFAULT_BUILD_DIR = _build.BUILD_DIR

_RECORDING: bool = False
_ENTRIES: List[Dict[str, Any]] = []
_SEEN_DIGESTS: set = set()

#: (found, built) when the directory was set or the stats cleared; None while it is off
_BASE: Optional[Tuple[int, int]] = None

_STATS: Dict[str, int] = {
    "disk_hits": 0,
    "compiles": 0,
    "prewarmed": 0,
    "manifest_entries": 0,
    "prewarm_failures": 0,
    "unrecordable": 0,
}

#: the report of the last :func:`prewarm` (``state_report()`` shows it)
_LAST_PREWARM: Optional[Dict[str, Any]] = None


class _Unrecordable(Exception):
    """An input leaf the manifest cannot encode (an exotic static object): the entry
    is dropped, never the update."""


# ---------------------------------------------------- persistent kernel directory


def enable_persistent_cache(cache_dir_: str) -> str:
    """Build and load the kernel libraries in ``cache_dir_`` from now on, and count
    ``disk_hits`` and ``compiles``."""
    global _CACHE_DIR
    cache_dir_ = str(cache_dir_)
    os.makedirs(cache_dir_, exist_ok=True)
    with _LOCK:
        _fold_counts()
        _build.BUILD_DIR = Path(cache_dir_)
        _CACHE_DIR = cache_dir_
        _set_base()
    return cache_dir_


def disable_persistent_cache() -> None:
    """Back to the checkout's ``build/kernels``; the counting stops."""
    global _CACHE_DIR
    with _LOCK:
        _fold_counts()
        _CACHE_DIR = None
        _set_base()
        _build.BUILD_DIR = _DEFAULT_BUILD_DIR


def cache_dir() -> Optional[str]:
    return _CACHE_DIR


def _live() -> Tuple[int, int]:
    """(libraries found built, libraries built plus steps built) in the process."""
    from metrics_tpu_torch.core.fused import steps_compiled

    return _build.BUILD_COUNTS["found"], _build.BUILD_COUNTS["built"] + steps_compiled()


def _set_base() -> None:
    global _BASE
    _BASE = _live() if _CACHE_DIR is not None else None


def _deltas() -> Tuple[int, int]:
    if _BASE is None:
        return 0, 0
    found, built = _live()
    return found - _BASE[0], built - _BASE[1]


def _fold_counts() -> None:
    """Add what the directory counted since its base to the kept stats."""
    hits, compiles = _deltas()
    _STATS["disk_hits"] += hits
    _STATS["compiles"] += compiles
    _set_base()


def stats() -> Dict[str, int]:
    """``disk_hits`` (kernel libraries found built) and ``compiles`` (``nvcc`` builds
    and steps the step caches built), both counted while the persistent directory is
    set; ``prewarmed``, ``prewarm_failures``, ``manifest_entries`` and ``unrecordable``."""
    with _LOCK:
        out = dict(_STATS)
        hits, compiles = _deltas()
    out["disk_hits"] += hits
    out["compiles"] += compiles
    return out


def clear_stats() -> None:
    with _LOCK:
        for key in _STATS:
            _STATS[key] = 0
        _set_base()


# ------------------------------------------------------- input (de)serializing


def _dtype_name(dtype: Any) -> str:
    """A torch dtype's name (``float32``); a numpy array becomes a tensor of the same
    dtype in the engines (``_split_inputs``), so both encode alike."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(torch.from_numpy(np.zeros(0, dtype=dtype)).dtype).replace("torch.", "")


def _encode(obj: Any) -> Any:
    """JSON encoding of an ``(args, kwargs)`` tree: tensors and arrays by shape and
    dtype, containers by marker (dicts keep their order: it is part of the tree
    spec), literals with their Python type."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return {"t": "aval", "shape": [int(s) for s in obj.shape], "dtype": _dtype_name(obj.dtype)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "lit", "py": type(obj).__name__, "v": obj}
    if isinstance(obj, tuple):
        return {"t": "tuple", "v": [_encode(e) for e in obj]}
    if isinstance(obj, list):
        return {"t": "list", "v": [_encode(e) for e in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise _Unrecordable("non-string dict key")
        return {"t": "dict", "v": [[k, _encode(v)] for k, v in obj.items()]}
    raise _Unrecordable(f"unrecordable static leaf: {type(obj).__name__}")


_LIT_TYPES = {"bool": bool, "int": int, "float": float, "str": str}


def _decode(obj: Any, device: torch.device) -> Any:
    """Inverse of :func:`_encode`; a tensor comes back as zeros of its recorded shape
    and dtype on ``device``."""
    if not isinstance(obj, dict) or "t" not in obj:
        raise _Unrecordable(f"malformed manifest node: {obj!r}")
    t = obj["t"]
    if t == "aval":
        dtype = getattr(torch, str(obj["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise _Unrecordable(f"unknown dtype {obj['dtype']!r}")
        return torch.zeros(tuple(obj["shape"]), dtype=dtype, device=device)
    if t == "lit":
        py = obj["py"]
        if py == "NoneType":
            return None
        if py not in _LIT_TYPES:
            raise _Unrecordable(f"unknown literal type {py!r}")
        return _LIT_TYPES[py](obj["v"])
    if t == "tuple":
        return tuple(_decode(e, device) for e in obj["v"])
    if t == "list":
        return [_decode(e, device) for e in obj["v"]]
    if t == "dict":
        return {k: _decode(v, device) for k, v in obj["v"]}
    raise _Unrecordable(f"unknown manifest node type {t!r}")


def _encode_inputs(args: Tuple, kwargs: Dict) -> Any:
    return _encode((tuple(args), dict(kwargs)))


def _decode_inputs(enc: Any, device: torch.device) -> Tuple[Tuple, Dict]:
    args, kwargs = _decode(enc, device)
    return tuple(args), dict(kwargs)


# ------------------------------------------------------------- recording


def recording() -> bool:
    """True while misses are recorded: the one check the engines make at a miss."""
    return _RECORDING


def enable_recording(clear: bool = False) -> None:
    global _RECORDING
    if clear:
        clear_manifest()
    _RECORDING = True


def disable_recording() -> None:
    global _RECORDING
    _RECORDING = False


def clear_manifest() -> None:
    with _LOCK:
        _ENTRIES.clear()
        _SEEN_DIGESTS.clear()


def manifest_entries() -> List[Dict[str, Any]]:
    with _LOCK:
        return [dict(e) for e in _ENTRIES]


def _record(make_entry: Any, digest: str) -> None:
    """Add the entry ``make_entry()`` under ``digest`` (once a digest)."""
    with _LOCK:
        if digest in _SEEN_DIGESTS:
            return
    try:
        entry = make_entry()
    except _Unrecordable:
        with _LOCK:
            _STATS["unrecordable"] += 1
        return
    entry["key_digest"] = digest
    with _LOCK:
        if digest in _SEEN_DIGESTS:
            return
        _SEEN_DIGESTS.add(digest)
        _ENTRIES.append(entry)
        _STATS["manifest_entries"] += 1
    if _obs._ENABLED:
        _obs.REGISTRY.inc("excache", "manifest_entries")


def record_fused_compile(
    *, mode: str, groups: List[Tuple[str, Tuple[str, ...]]], args: Tuple, kwargs: Dict, digest: str
) -> None:
    """A fused engine's miss (``FusedCollectionUpdate._launch``)."""
    if not _RECORDING:
        return
    _record(lambda: {
        "engine": "fused",
        "mode": mode,
        "groups": [[name, list(members)] for name, members in groups],
        "inputs": _encode_inputs(args, kwargs),
    }, digest)


def record_fleet_compile(metric: Any, tag: str, args: Tuple, kwargs: Dict, stream_ids: Any, digest: str) -> None:
    """A fleet step's miss (``core.fleet.run_step``); ``kwargs`` without ``stream_ids``."""
    if not _RECORDING:
        return
    _record(lambda: {
        "engine": "fleet",
        "tag": tag,
        "metric": type(metric).__name__,
        "fleet_size": int(metric.fleet_size),
        "inputs": _encode_inputs(args, kwargs),
        "stream_ids": None if stream_ids is None else _encode(stream_ids),
    }, digest)


def record_ingest_compile(queue: Any, chain: List[Tuple[str, Any]], uniform: bool, entries: List[Any],
                          key: Tuple) -> None:
    """An ingest chain's miss (``IngestQueue._launch_chain``). A uniform chain keeps
    entry 0 and the count; the digest leaves out the leaders' ``id()``."""
    if not _RECORDING:
        return
    topo, state_key, sig = key
    digest = _fused.stable_key_digest((tuple(label for label, _ in topo), state_key, sig))
    recorded = entries[:1] if uniform else entries
    _record(lambda: {
        "engine": "ingest",
        "scan": bool(uniform),
        "count": len(entries),
        "chain": [label for label, _ in chain],
        "entries": [_encode_inputs(e.args, e.kwargs) for e in recorded],
    }, digest)


# --------------------------------------------------------------- manifest IO


def _stamp() -> Dict[str, Any]:
    """What a capture depends on besides the entry: torch, CUDA and the card."""
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(torch.cuda.current_device()) if cuda else "cpu",
    }


def manifest_payload() -> Dict[str, Any]:
    """The document :func:`save_manifest` writes: the schema, the stamp and the
    entries."""
    return {"schema": SCHEMA_VERSION, **_stamp(), "entries": manifest_entries()}


def save_manifest(path: str) -> str:
    """Write the manifest atomically (the checkpoint records' tmp, fsync, rename)."""
    from metrics_tpu_torch.ckpt.manager import _atomic_write_json

    _atomic_write_json(path, manifest_payload())
    return path


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


# ----------------------------------------------------------------- prewarm


def _warn_skip(reason: str) -> None:
    warnings.warn(
        f"excache.prewarm: {reason}; skipped, its step is captured lazily at first use instead.",
        MetricsUserWarning,
        stacklevel=3,
    )


def _prewarm_fused(target: Any, entry: Dict[str, Any]) -> bool:
    if getattr(target, "_groups", None) is None or not getattr(target, "fused", False):
        return False
    groups = [(str(name), tuple(members)) for name, members in entry["groups"]]
    if any(name not in target._modules for name, _ in groups):
        _warn_skip("manifest fused groups do not match the live collection")
        return False
    engine = _fused.engine_for(target)
    forward = entry["mode"] == "forward"
    device = target._modules[groups[0][0]].device
    args, kwargs = _decode_inputs(entry["inputs"], device)
    dyn, split_spec = _fused._split_inputs(args, kwargs, device)
    states = {name: target._modules[name].state_pytree() for name, _ in groups}
    topo = tuple((name, members, id(target._modules[name])) for name, members in groups)
    key = (entry["mode"], topo, _fused._tensor_key(states), _fused._tensor_key(dyn), _fused._static_key(split_spec))
    return engine._steps.insert(key, lambda: engine._build(target, groups, split_spec, forward), states, [dyn])


def _prewarm_fleet(target: Any, entry: Dict[str, Any]) -> bool:
    from metrics_tpu_torch.core import fleet as _fleet

    if getattr(target, "fleet_size", None) is None:
        return False
    if type(target).__name__ != entry["metric"] or int(target.fleet_size) != entry["fleet_size"]:
        _warn_skip("manifest fleet entry does not match the live metric")
        return False
    if target.device.type != "cuda":
        return False  # the CPU runs fleet steps eagerly: there is no step cache to fill
    args, kwargs = _decode_inputs(entry["inputs"], target.device)
    raw_update = type(target).update.__get__(target)
    dyn, spec = _fused._split_inputs(args, kwargs)
    state = {name: getattr(target, name) for name in target._defaults}
    tag = entry["tag"]
    if tag == "fleet.bcast":

        def step(st, dl):
            a, k = _fused._merge_inputs(dl, spec)
            return _fleet.broadcast_new_state(target, raw_update, st, a, k)

        extras: Tuple = (dyn,)
    elif tag == "fleet.route" and entry.get("stream_ids") is not None:
        ids = _decode(entry["stream_ids"], target.device)

        def step(st, dl, i_):
            a, k = _fused._merge_inputs(dl, spec)
            return _fleet.routed_new_state(target, raw_update, st, a, k, i_)

        extras = (dyn, ids)
    else:
        _warn_skip(f"unknown fleet tag {tag!r}")
        return False
    key = (tag, _fused._tensor_key(state), _fused._tensor_key(list(extras)), _fused._static_key(spec))
    return _fleet._steps_for(target).insert(key, lambda: lambda st, *ex: (step(st, *ex), None), state, extras)


def _prewarm_ingest(target: Any, entry: Dict[str, Any]) -> bool:
    if not hasattr(target, "_chain_step"):
        return False
    chain, _eager, is_collection = target._plan()
    if not chain:
        return False
    if [label for label, _ in chain] != list(entry["chain"]):
        _warn_skip("manifest ingest chain does not match the live queue target")
        return False
    device = chain[0][1].device
    inputs = [_decode_inputs(e, device) for e in entry["entries"]]
    if entry["scan"]:
        inputs = inputs * int(entry["count"])
    key, states, dyn_lists, make_step, _uniform = target._chain_step(chain, inputs, is_collection)
    # the capture's trace is no update: the obs counters stay off, as in a live tick's
    prev = _obs._ENABLED
    _obs._ENABLED = False
    try:
        return target._steps.insert(key, make_step, states, [dyn_lists])
    finally:
        _obs._ENABLED = prev


def _prewarm_entry(target: Any, entry: Dict[str, Any]) -> bool:
    engine = entry.get("engine")
    if engine == "fused":
        return _prewarm_fused(target, entry)
    if engine == "fleet":
        return _prewarm_fleet(target, entry)
    if engine == "ingest":
        return _prewarm_ingest(target, entry)
    _warn_skip(f"the port keeps no step cache for manifest engine {engine!r}")
    return False


def prewarm(target: Any, manifest: Any) -> Dict[str, Any]:
    """Capture every matching entry of ``manifest`` (a path or a loaded dict) into the
    step caches of ``target``: a fused ``MetricCollection``, a fleet ``Metric`` or an
    ``IngestQueue``. Entries of another kind of target are skipped silently, so one
    manifest can be replayed against each serving object.

    Never raises (see the module docstring). Returns ``{entries, compiled, skipped,
    failed, seconds}``, also kept for ``state_report()`` and recorded as the
    ``excache_prewarm`` flight event.
    """
    global _LAST_PREWARM
    t0 = time.perf_counter()
    report = {"entries": 0, "compiled": 0, "skipped": 0, "failed": 0, "seconds": 0.0}
    if isinstance(manifest, (str, os.PathLike)):
        try:
            manifest = load_manifest(str(manifest))
        except Exception as err:  # noqa: BLE001 - startup must not fail
            _warn_skip(f"unreadable manifest ({type(err).__name__}: {err})")
            report["seconds"] = time.perf_counter() - t0
            _LAST_PREWARM = report
            return report
    entries = manifest.get("entries") if isinstance(manifest, dict) else None
    if not isinstance(entries, list):
        _warn_skip("manifest has no entry list (schema drift?)")
        entries = []
    elif manifest.get("schema") != SCHEMA_VERSION:
        _warn_skip(f"manifest schema {manifest.get('schema')!r} != supported {SCHEMA_VERSION}")
        report["skipped"] = len(entries)
        entries = []
    else:
        recorded = {k: manifest.get(k) for k in ("torch_version", "cuda_version", "device_name")}
        if recorded != _stamp():
            # a capture depends on torch, CUDA and the card: replaying another stamp's
            # entries could capture steps the live process never asks for
            _warn_skip(f"manifest recorded under {recorded}, running {_stamp()}")
            report["skipped"] = len(entries)
            entries = []
    for entry in entries:
        report["entries"] += 1
        try:
            if _fault._SCHEDULE is not None:
                _fault.fire("excache.prewarm", engine=entry.get("engine"), digest=entry.get("key_digest"))
            ok = _prewarm_entry(target, entry)
        except Exception as err:  # noqa: BLE001 - degrade to a lazy capture
            report["failed"] += 1
            with _LOCK:
                _STATS["prewarm_failures"] += 1
            _fused._warn_degrade_once("excache.prewarm", err, "the entry's step is captured at first use instead.")
            if _obs._ENABLED and _obs_flight._RING is not None:
                _obs_flight.record(
                    "degrade", site="excache.prewarm", engine=entry.get("engine"),
                    error=f"{type(err).__name__}: {str(err).splitlines()[0][:120] if str(err) else ''}",
                )
            continue
        if ok:
            report["compiled"] += 1
            with _LOCK:
                _STATS["prewarmed"] += 1
            if _obs._ENABLED:
                _obs.REGISTRY.inc("excache", "prewarmed")
        else:
            report["skipped"] += 1
    report["seconds"] = time.perf_counter() - t0
    _LAST_PREWARM = report
    if _obs._ENABLED:
        _obs.REGISTRY.observe_duration("excache", "prewarm_s", report["seconds"])
        if _obs_flight._RING is not None:
            _obs_flight.record("excache_prewarm", **report)
    return report


def last_prewarm() -> Optional[Dict[str, Any]]:
    """The report of the last :func:`prewarm` in this process."""
    return None if _LAST_PREWARM is None else dict(_LAST_PREWARM)

