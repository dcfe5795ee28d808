"""Checkpoint manager: versioned step directories, atomic commits, async writes,
coordination of many hosts, retention (counterpart of ``metrics_tpu/ckpt/manager.py``).

On-disk layout (one directory per checkpoint series), the JAX package's::

    ckpts/
      step_0000000042/            # committed checkpoint (atomically renamed)
        manifest-h0000.json       # per-host manifest (schema + payload index)
        arrays-h0000.bin          # per-host payload blob
        COMMIT                    # commit record: {step, world, ...}
      .tmp-step_0000000043/       # in-flight write (ignored by readers)

Atomicity: payloads are written and fsynced before their manifest, manifests before
the ``COMMIT`` record, and the step directory keeps a ``.tmp-`` name until the
commit record exists; one ``os.rename`` then publishes it (and a directory fsync
makes the rename durable). A kill at any point leaves either a committed step or an
ignored tmp directory.

Many hosts (barrier-free, shared filesystem): every host writes its payload and
manifest into the same tmp directory, then checks whether all ``world`` manifests of
this save's *generation* are present; the host that sees completeness writes
``COMMIT`` and renames. Rename races are benign. The generation stamp keeps the
manifests of a preempted incarnation out of a fresh save of the same step
(:func:`_save_generation`).

Async: torch tensors are mutable (``update`` accumulates in place, a captured step's
replay overwrites its buffers), so ``blocking=False`` copies every state tensor on
the current stream before it returns (a clone on the card, a CUDA event marking its
end); a daemon thread waits for the event, moves the copies to the host, writes and
commits. The returned :class:`CheckpointWrite` has ``result()``/``done()``;
:func:`wait_for_all_saves` joins every write in flight.

Riders: while ``serve.excache`` records, a save writes ``warm_manifest.json`` into
the series directory; while the flight recorder runs, a save records
``ckpt_save_begin``/``ckpt_save_retry``/``ckpt_save_commit`` events (and, while
``obs.flow`` traces, a ``ckpt_flows`` event naming the flows the save holds) and, with
its ``ckpt_integration``, writes ``flight-h<rank>.json`` into the step directory before
the commit.
"""
import json
import os
import random
import re
import shutil
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.ckpt import manifest as _manifest
from metrics_tpu_torch.ckpt import restore as _restore
from metrics_tpu_torch.ckpt import serializer as _serializer
from metrics_tpu_torch.ckpt.errors import (
    CheckpointError,
    CheckpointNotFoundError,
    CheckpointTimeoutError,
    CorruptCheckpointError,
    IncompleteCheckpointError,
    SchemaDriftError,
)
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import flight as _obs_flight
from metrics_tpu_torch.obs import registry as _obs

_STEP_RE = re.compile(r"^step_(\d{10})$")
_TMP_PREFIX = ".tmp-"


def _step_name(step: int) -> str:
    return f"step_{int(step):010d}"


def _manifest_name(host: int) -> str:
    return f"manifest-h{host:04d}.json"


def _payload_name(host: int) -> str:
    return f"arrays-h{host:04d}.bin"


def _is_committed(step_dir: str) -> bool:
    return os.path.isfile(os.path.join(step_dir, "COMMIT"))


def all_steps(directory: str) -> List[int]:
    """Committed step numbers in ``directory``, ascending (tmp and partial
    directories are not checkpoints yet)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for entry in os.listdir(directory):
        m = _STEP_RE.match(entry)
        if m and _is_committed(os.path.join(directory, entry)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _fsync_dir(path: str) -> None:
    """fsync a directory so that a rename in it survives power loss (best effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".part"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, sort_keys=True)
        fh.flush()
        if _fault._SCHEDULE is not None:
            _fault.fire("ckpt.fsync", path=os.path.basename(path))
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _read_json(path: str, what: str) -> Dict[str, Any]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        raise
    except (OSError, ValueError) as err:
        raise CorruptCheckpointError(f"unreadable checkpoint {what} at {path}: {err}") from err


# ------------------------------------------------------------------ handles


class CheckpointWrite:
    """Handle of one (possibly async) checkpoint save."""

    def __init__(self, directory: str, step: int) -> None:
        self.directory = directory
        self.step = step
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._path: Optional[str] = None
        self._committed = False

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def committed(self) -> bool:
        """True once the step's ``COMMIT`` record exists (re-checked on disk, so a
        peer host committing later shows on the same handle)."""
        if not self._committed and self._path is not None and _is_committed(self._path):
            self._committed = True
        return self._committed

    def result(self, timeout: Optional[float] = None) -> str:
        """Wait for this host's write; returns the step directory the save commits
        into. Re-raises the writer's exception."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"checkpoint write for step {self.step} still in flight")
        if self._error is not None:
            raise self._error
        return self._path  # type: ignore[return-value]

    def _finish(self, path: Optional[str], error: Optional[BaseException], committed: bool = False) -> None:
        self._path, self._error, self._committed = path, error, committed
        self._done.set()


def _entries_to_host(entries: List[Tuple[str, Any, bool]], ready: Any) -> None:
    """Move an async save's copied entries to the host, in place, on the writer
    thread. The copies were enqueued on the saving thread's current stream; ``ready``
    (a CUDA event recorded after them, None on the CPU) orders these reads after them.
    Nothing else holds the copies, so nothing can overwrite them meanwhile."""
    if ready is not None:
        ready.synchronize()
    for i, (key, value, is_cat) in enumerate(entries):
        if isinstance(value, torch.Tensor):
            entries[i] = (key, _serializer.HostValue(*_serializer.to_host(value)), is_cat)


def secure_pending_snapshots(arrays: Any) -> int:
    """Make in-flight async snapshots safe from the invalidation of ``arrays``;
    returns the number of entries moved to the host.

    In the JAX package an async snapshot holds references to immutable arrays, and
    this moves the ones about to be donated to the host first. The port's snapshot is
    a copy taken at the save call, which no update, replay or donation can touch, so
    nothing needs securing: it returns 0. Kept for the JAX package's callers.
    """
    return 0


_INFLIGHT: List[CheckpointWrite] = []
_INFLIGHT_LOCK = threading.Lock()
# the highest step this process assigned per series directory: auto-stepping must
# not reuse a step whose async write has not committed yet
_LAST_ASSIGNED: Dict[str, int] = {}


def wait_for_all_saves(require_committed: bool = False, timeout_s: Optional[float] = None) -> None:
    """Join every in-flight async save (re-raising the first failure).

    A joined save of many hosts can still wait for a peer's manifest: that warns
    (``RuntimeWarning``), or raises :class:`IncompleteCheckpointError` with
    ``require_committed``. ``timeout_s`` bounds the whole wait; past it
    :class:`CheckpointTimeoutError` lists the stuck steps (they stay registered).
    The snapshots were copied at their save calls, so the live metrics may go on
    updating meanwhile.
    """
    with _INFLIGHT_LOCK:
        pending = list(_INFLIGHT)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    stuck: List[int] = []
    for handle in pending:
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        try:
            handle.result(remaining)
        except TimeoutError:
            stuck.append(handle.step)
    if stuck:
        raise CheckpointTimeoutError(
            f"checkpoint write(s) for step(s) {sorted(stuck)} still in flight after"
            f" {timeout_s}s (writer thread wedged or IO stalled)",
            steps=sorted(stuck),
        )
    uncommitted = sorted(h.step for h in pending if not h.committed)
    if uncommitted:
        msg = (
            f"checkpoint step(s) {uncommitted} are fully written by this host but"
            " not committed: not every peer host's manifest has arrived"
        )
        if require_committed:
            raise IncompleteCheckpointError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)


# -------------------------------------------------------------------- save

_GENERATION_LOCK = threading.Lock()
_GENERATION: Dict[str, str] = {}


def _save_generation(world: int) -> str:
    """Generation nonce stamped into every manifest of a save.

    :func:`_try_commit` counts only manifests of its own generation, so manifests a
    preempted incarnation left in a tmp directory never mix into a fresh save of the
    same step. The hosts of one incarnation agree on it:

    - ``world == 1``: a random nonce of this process.
    - a ``torch.distributed`` group is initialised and its size is ``world``: rank
      0's random nonce, sent once per process with ``broadcast_object_list`` (one
      collective per process, not per save; the commit stays barrier-free).
    - otherwise (a topology given by ``process_index=``/``process_count=``): separate
      processes cannot agree without talking, so the stamp is a constant and commit
      falls back to the all-manifests-present rule; pass ``generation=`` (a
      launcher's attempt id) for staleness protection.
    """
    import torch.distributed as dist

    if world == 1:
        key = "local"
    elif dist.is_available() and dist.is_initialized() and dist.get_world_size() == world:
        key = "shared"
    else:
        return "-"
    with _GENERATION_LOCK:
        nonce = _GENERATION.get(key)
        if nonce is None:
            raw = int.from_bytes(os.urandom(8), "big") >> 1
            if key == "shared":
                box = [raw]
                dist.broadcast_object_list(box, src=0)
                raw = int(box[0])
            nonce = f"{raw:016x}"
            _GENERATION[key] = nonce
    return nonce


def _snapshot(obj: Any, persistent_only: bool, copy: bool) -> Tuple[Dict[str, Any], List[Tuple[str, Any, bool]]]:
    """Host-side schema tree and ``(key, tensor, is_cat)`` entries (copies with
    ``copy``). A collection saves each compute group once, from its leader: a fused
    leader's states are its captured step's buffers, read here."""
    from metrics_tpu_torch.core.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        groups = _manifest.collection_groups(obj)
        tree: Dict[str, Any] = {
            "kind": "collection",
            "metrics": {name: _manifest.metric_schema(m, persistent_only) for name, m in obj._modules.items()},
            "groups": groups,
            "update_counts": {name: int(m._update_count) for name, m in obj._modules.items()},
        }
        entries: List[Tuple[str, Any, bool]] = []
        for group in groups:
            entries.extend(
                _serializer.snapshot_state(obj._modules[group[0]], f"{group[0]}/", persistent_only, copy)
            )
        return tree, entries
    return (
        {"kind": "metric", "schema": _manifest.metric_schema(obj, persistent_only)},
        _serializer.snapshot_state(obj, persistent_only=persistent_only, copy=copy),
    )


def _ready_event(entries: List[Tuple[str, Any, bool]]) -> Any:
    """A CUDA event after the snapshot's copies, on the current stream of their
    device; None when no entry is on a card."""
    for _, value, _ in entries:
        if isinstance(value, torch.Tensor) and value.is_cuda:
            with torch.cuda.device(value.device):
                event = torch.cuda.Event()
                event.record()
            return event
    return None


def _prune(directory: str, retain: int) -> None:
    steps = all_steps(directory)
    for step in steps[:-retain] if retain > 0 else []:
        shutil.rmtree(os.path.join(directory, _step_name(step)), ignore_errors=True)


def _sweep_stale_shards(tmp_dir: str, world: int) -> None:
    """Remove shard files a preempted larger-world incarnation left (hosts ``>=
    world``, their ``.part`` files too) so that they do not ride into the committed
    step."""
    try:
        entries = os.listdir(tmp_dir)
    except OSError:
        return
    for entry in entries:
        m = re.match(r"^(?:manifest|arrays)-h(\d{4})\.", entry)
        if m and int(m.group(1)) >= world:
            try:
                os.remove(os.path.join(tmp_dir, entry))
            except OSError:
                pass


def _try_commit(directory: str, tmp_dir: str, step: int, world: int, generation: str) -> bool:
    """Barrier-free commit: when all ``world`` manifests of this generation are
    present, write the COMMIT record and rename the tmp directory into place.
    True when the step is committed (by this host or a racing one); False while a
    peer manifest is missing or stale."""
    final_dir = os.path.join(directory, _step_name(step))
    if _is_committed(final_dir):
        return True
    if not os.path.isdir(tmp_dir):
        return _is_committed(final_dir)
    for host in range(world):
        try:
            peer = _read_json(os.path.join(tmp_dir, _manifest_name(host)), "manifest")
        except FileNotFoundError:
            return _is_committed(final_dir)
        except CorruptCheckpointError:
            return False  # a torn write of a dead incarnation
        # a manifest without a stamp comes from a writer before generations: it counts
        if peer.get("generation", generation) != generation:
            return False
    _sweep_stale_shards(tmp_dir, world)
    try:
        _atomic_write_json(
            os.path.join(tmp_dir, "COMMIT"),
            {
                "format": _manifest.FORMAT,
                "version": _manifest.FORMAT_VERSION,
                "step": step,
                "world": world,
                "generation": generation,
                "time_unix": time.time(),
            },
        )
    except FileNotFoundError:
        if _is_committed(final_dir):
            return True  # a racing host committed first
        raise
    try:
        if _fault._SCHEDULE is not None:
            _fault.fire("ckpt.rename", step=step)
        os.rename(tmp_dir, final_dir)
    except OSError:
        if not _is_committed(final_dir):
            raise
        return True  # a racing host renamed first
    _fsync_dir(directory)
    return True


def _stamp(obj: Any, **stats: Any) -> None:
    """Keep the last save's or restore's figures on the object (``_ckpt_stats``)."""
    try:
        ckpt_stats = getattr(obj, "_ckpt_stats", None)
        if not isinstance(ckpt_stats, dict):
            ckpt_stats = {}
        ckpt_stats.update(stats)
        object.__setattr__(obj, "_ckpt_stats", ckpt_stats)
    except Exception:  # noqa: BLE001 - figures are best effort
        pass


def save_checkpoint(
    obj: Any,
    directory: str,
    step: Optional[int] = None,
    *,
    blocking: bool = True,
    retain: Optional[int] = None,
    replicated: bool = True,
    persistent_only: bool = False,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    generation: Optional[str] = None,
    retries: int = 3,
    retry_backoff_s: float = 0.05,
) -> CheckpointWrite:
    """Save a :class:`Metric` or :class:`MetricCollection` checkpoint.

    Args:
        obj: the live metric or collection; updates may go on at once (an async
            save copies the states before it returns).
        directory: the checkpoint series directory (made if missing).
        step: a monotonically increasing version; ``latest + 1`` by default.
        blocking: ``False`` copies the states on the current stream and returns;
            a background thread moves them to the host and writes. Call
            ``.result()`` on the handle to join.
        retain: keep only the newest ``retain`` committed steps.
        replicated: array states are the same on every host (host 0 writes them,
            the others only their cat shards). ``False`` for per-host accumulation:
            every host writes every state, and restore re-reduces on a topology
            change.
        persistent_only: save only the states registered with ``persistent=True``.
        process_index / process_count: override the topology (by default the
            ``torch.distributed`` default group's, else one process).
        generation: the stamp shared by the hosts of this save; by default
            :func:`_save_generation`'s nonce.
        retries: save-IO attempts (default 3); a transient ``OSError`` (an injected
            fault too) is retried after ``retry_backoff_s * 2**k`` seconds, jittered
            by a factor in ``[0.5, 1.5)``; the last failure comes through the handle.

    Returns:
        A :class:`CheckpointWrite` (finished when blocking; ``committed`` says
        whether the step is readable yet).
    """
    from metrics_tpu_torch.parallel.collective import process_topology

    rank, world = process_topology(process_index, process_count)
    if generation is None:
        generation = _save_generation(world)
    os.makedirs(directory, exist_ok=True)
    dir_key = os.path.abspath(directory)
    last = latest_step(directory) if step is None else None
    with _INFLIGHT_LOCK:
        if step is None:
            step = max(-1 if last is None else last, _LAST_ASSIGNED.get(dir_key, -1)) + 1
        _LAST_ASSIGNED[dir_key] = max(_LAST_ASSIGNED.get(dir_key, -1), step)
    final_dir = os.path.join(directory, _step_name(step))
    if _is_committed(final_dir):
        raise CheckpointError(f"checkpoint step {step} already exists in {directory}")

    # a checkpoint of a queue-fronted target carries every enqueued row; resolved
    # through sys.modules so that the ingest module costs nothing unless in use
    _ingest = sys.modules.get("metrics_tpu_torch.serve.ingest")
    if _ingest is not None:
        _ingest.flush_for(obj)

    # while the executable cache records, every save refreshes the warm manifest in
    # the series directory, so that a restarting replica finds it beside the state;
    # best effort: a lost manifest costs warm-up, never the save
    _excache = sys.modules.get("metrics_tpu_torch.serve.excache")
    if _excache is not None and _excache.recording() and rank == 0:
        try:
            _excache.save_manifest(os.path.join(directory, _excache.MANIFEST_NAME))
        except Exception as err:  # noqa: BLE001 - the checkpoint must not fail
            warnings.warn(
                f"warm-manifest write failed ({type(err).__name__}: {err}); the checkpoint proceeds without it.",
                RuntimeWarning,
            )

    tree, entries = _snapshot(obj, persistent_only, copy=not blocking)
    if _obs._ENABLED and _obs_flight._RING is not None:
        # a post-mortem wants the state layout of what was being saved
        _obs_flight.note_state_source(obj)
        _obs_flight.record("ckpt_save_begin", step=step, host=rank, blocking=blocking)
        # flow containment: the flight window names the traced flows whose rows this
        # checkpoint holds, those closed against ``obj`` since the last save's drain
        _flow = sys.modules.get("metrics_tpu_torch.obs.flow")
        if _flow is not None and _flow.active():
            flow_ids = _flow.drain_for_ckpt(obj)
            if flow_ids:
                _obs_flight.record("ckpt_flows", step=step, host=rank, count=len(flow_ids), flows=flow_ids[-64:])
    ready = None if blocking else _ready_event(entries)
    handle = CheckpointWrite(directory, step)

    def attempt_io() -> Tuple[Dict[str, Any], bool]:
        """One idempotent save attempt: payload, manifest, commit."""
        tmp_dir = os.path.join(directory, _TMP_PREFIX + _step_name(step))
        try:
            os.makedirs(tmp_dir, exist_ok=True)
            mine = entries if (rank == 0 or not replicated) else [e for e in entries if e[2]]
            if _fault._SCHEDULE is not None:
                _fault.fire("ckpt.write", step=step, host=rank)
            payload_meta = _serializer.write_payload(os.path.join(tmp_dir, _payload_name(rank)), mine)
            _atomic_write_json(
                os.path.join(tmp_dir, _manifest_name(rank)),
                {
                    "format": _manifest.FORMAT,
                    "version": _manifest.FORMAT_VERSION,
                    "step": step,
                    "host": rank,
                    "world": world,
                    "generation": generation,
                    "replicated": replicated,
                    "persistent_only": persistent_only,
                    "tree": tree,
                    "payload": payload_meta,
                },
            )
        except FileNotFoundError:
            # the tmp directory vanished mid-write: a racing host committed it
            if not _is_committed(final_dir):
                raise
            payload_meta = {"nbytes": 0}
        if _obs_flight.ckpt_integration_active():
            # the flight window rides the step directory through the atomic commit
            # (best effort: a vanished tmp_dir gives no dump, not a failed save)
            _obs_flight.dump(os.path.join(tmp_dir, f"flight-h{rank:04d}.json"), state_objs=[obj])
        committed = _try_commit(directory, tmp_dir, step, world, generation)
        if committed and retain is not None:
            _prune(directory, retain)
        return payload_meta, committed

    attempts = max(1, int(retries))

    def write() -> None:
        t0 = time.perf_counter()
        try:
            if not blocking:
                _entries_to_host(entries, ready)
            for attempt in range(attempts):
                try:
                    payload_meta, committed = attempt_io()
                    break
                except OSError as err:
                    if attempt + 1 >= attempts:
                        raise
                    if _obs._ENABLED:
                        _obs.REGISTRY.inc("ckpt", "save_retries")
                        if _obs_flight._RING is not None:
                            _obs_flight.record("ckpt_save_retry", step=step, host=rank, attempt=attempt + 1,
                                               error=f"{type(err).__name__}: {str(err)[:120]}")
                    time.sleep(retry_backoff_s * (2**attempt) * (0.5 + random.random()))
            elapsed_ms = (time.perf_counter() - t0) * 1000
            if _obs._ENABLED:
                _obs.REGISTRY.inc("ckpt", "saves")
                _obs.REGISTRY.inc("ckpt", "bytes", payload_meta["nbytes"])
                _obs.REGISTRY.inc("ckpt", "save_ms", elapsed_ms)
                if _obs_flight._RING is not None:
                    _obs_flight.record("ckpt_save_commit", step=step, host=rank, committed=committed,
                                       nbytes=payload_meta["nbytes"], elapsed_ms=round(elapsed_ms, 3))
            _stamp(obj, last_save_ms=round(elapsed_ms, 3), last_save_step=step, last_save_bytes=payload_meta["nbytes"])
            handle._finish(final_dir, None, committed=committed)
        except BaseException as err:  # noqa: BLE001 - surfaced through handle.result()
            if _obs._ENABLED and _obs_flight._RING is not None:
                _obs_flight.record("ckpt_save_failed", step=step, host=rank,
                                   error=f"{type(err).__name__}: {str(err)[:120]}")
            handle._finish(None, err)
        finally:
            with _INFLIGHT_LOCK:
                if handle in _INFLIGHT:
                    _INFLIGHT.remove(handle)

    if blocking:
        write()
        handle.result()
    else:
        with _INFLIGHT_LOCK:
            _INFLIGHT.append(handle)
        threading.Thread(target=write, name=f"metrics-tpu-torch-ckpt-{step}", daemon=True).start()
    return handle


# ------------------------------------------------------------------ restore


def _resolve_step_dir(directory: str, step: Optional[int]) -> Tuple[int, str]:
    if step is None:
        found = latest_step(directory)
        if found is None:
            raise CheckpointNotFoundError(f"no committed checkpoint found in {directory!r}")
        return found, os.path.join(directory, _step_name(found))
    step_dir = os.path.join(directory, _step_name(step))
    if not os.path.isdir(step_dir):
        if os.path.isdir(os.path.join(directory, _TMP_PREFIX + _step_name(step))):
            raise IncompleteCheckpointError(f"checkpoint step {step} in {directory!r} was started but never committed")
        raise CheckpointNotFoundError(f"no checkpoint for step {step} in {directory!r}")
    if not _is_committed(step_dir):
        raise IncompleteCheckpointError(f"checkpoint step {step} in {directory!r} has no commit record (partial write)")
    return step, step_dir


def restore_checkpoint(
    obj: Any,
    directory: str,
    step: Optional[int] = None,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    stream: Optional[int] = None,
    fallback_steps: int = 0,
) -> int:
    """Restore ``obj`` (Metric or MetricCollection) from a committed checkpoint;
    returns the step.

    The saved manifest is validated against the live tree first (typed errors, no
    partial loads), then the states are assigned: compute groups re-aliased for a
    collection, states re-reduced or re-packed when the host count differs. A
    checkpoint written by the JAX package restores here wherever the dtypes agree.

    ``stream`` slices one stream out of a fleet checkpoint into a plain instance of
    the same class. ``fallback_steps`` walks back to the newest earlier committed
    step when the requested one is corrupt or incomplete, at most that many times
    (with a ``RuntimeWarning``); drift never falls back.
    """
    fallbacks_left = int(fallback_steps)
    attempt_step = step
    while True:
        try:
            return _restore_checkpoint_once(
                obj, directory, attempt_step, process_index=process_index, process_count=process_count, stream=stream
            )
        except (CorruptCheckpointError, IncompleteCheckpointError) as err:
            if fallbacks_left <= 0:
                raise
            failed = attempt_step if attempt_step is not None else latest_step(directory)
            earlier = [s for s in all_steps(directory) if failed is None or s < failed]
            if not earlier:
                raise
            attempt_step = earlier[-1]
            fallbacks_left -= 1
            if _obs._ENABLED:
                _obs.REGISTRY.inc("ckpt", "restore_fallbacks")
                if _obs_flight._RING is not None:
                    _obs_flight.record("ckpt_restore_fallback", failed_step=failed, fallback_step=attempt_step,
                                       error=f"{type(err).__name__}: {str(err)[:120]}")
            warnings.warn(
                f"checkpoint step {failed} in {directory!r} is unusable"
                f" ({type(err).__name__}); falling back to committed step"
                f" {attempt_step} ({fallbacks_left} fallback(s) left)",
                RuntimeWarning,
                stacklevel=2,
            )


def _restore_checkpoint_once(
    obj: Any,
    directory: str,
    step: Optional[int] = None,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    stream: Optional[int] = None,
) -> int:
    """One all-or-nothing restore attempt (see :func:`restore_checkpoint`)."""
    from metrics_tpu_torch.core.collections import MetricCollection
    from metrics_tpu_torch.parallel.collective import process_topology

    rank, world = process_topology(process_index, process_count)
    step, step_dir = _resolve_step_dir(directory, step)
    t0 = time.perf_counter()
    commit = _read_json(os.path.join(step_dir, "COMMIT"), "commit record")
    saved_world = int(commit.get("world", 1))
    manifests = []
    for host in range(saved_world):
        path = os.path.join(step_dir, _manifest_name(host))
        try:
            manifests.append(_read_json(path, "manifest"))
        except FileNotFoundError:
            raise IncompleteCheckpointError(
                f"committed checkpoint {step_dir} is missing {_manifest_name(host)}"
                f" (commit record promises {saved_world} hosts)"
            ) from None
    replicated = bool(manifests[0].get("replicated", True))
    persistent_only = bool(manifests[0].get("persistent_only", False))
    payloads = [_serializer.load_payload(os.path.join(step_dir, m["payload"]["file"]), m["payload"]) for m in manifests]
    bytes_read = sum(int(m["payload"]["nbytes"]) for m in manifests)

    own = manifests[rank]["tree"] if world == saved_world else None
    tree = own or manifests[0]["tree"]

    if isinstance(obj, MetricCollection):
        if stream is not None:
            raise CheckpointError("stream= slicing applies to single fleet-metric restores, not collections")
        _restore_collection(
            obj, tree, manifests, payloads,
            rank=rank, world=world, saved_world=saved_world, replicated=replicated, persistent_only=persistent_only,
        )
    else:
        if tree.get("kind") != "metric":
            raise CheckpointError("checkpoint was saved from a MetricCollection; restore into a collection")
        saved_schema = tree["schema"]
        if stream is not None:
            saved_n = saved_schema.get("fleet_size")
            if saved_n is None:
                raise CheckpointError(
                    "stream= slicing requires a fleet checkpoint; this one was saved from a metric without a fleet axis"
                )
            if not 0 <= stream < saved_n:
                raise CheckpointError(f"stream={stream} out of range for the saved fleet_size={saved_n}")
            saved_schema = _restore.slice_fleet_schema(saved_schema)
            payloads = _restore.slice_fleet_payloads(payloads, tree["schema"], stream)
        # the live schema stays whole for persistent_only checkpoints: allow_subset
        # loads the saved subset, the other states keep their values
        live = _manifest.metric_schema(obj)
        _manifest.validate_schema(live, saved_schema, allow_subset=persistent_only)
        _manifest.widen_counts(live, saved_schema, payloads)
        count = _restore.merged_update_count(
            [m["tree"]["schema"] for m in manifests], own["schema"] if own is not None else None
        )
        _restore.assign_metric_state(
            obj, saved_schema, payloads,
            rank=rank, world=world, saved_world=saved_world, replicated=replicated, update_count=count,
        )
    elapsed_ms = (time.perf_counter() - t0) * 1000
    if _obs._ENABLED:
        _obs.REGISTRY.inc("ckpt", "restores")
        _obs.REGISTRY.inc("ckpt", "bytes", bytes_read)
        _obs.REGISTRY.inc("ckpt", "restore_ms", elapsed_ms)
        if _obs_flight._RING is not None:
            _obs_flight.record("ckpt_restore", step=step, nbytes=bytes_read, elapsed_ms=round(elapsed_ms, 3))
    _stamp(obj, last_restore_ms=round(elapsed_ms, 3), last_restore_step=step, last_restore_bytes=bytes_read)
    return step


def _member_update_counts(tree: Dict[str, Any], manifests: List[Dict[str, Any]], *, topo_changed: bool) -> Dict[str, int]:
    """Per-member update counts to restore: the restoring host's own on the same
    topology, else each member's largest over the saved hosts."""
    counts = {name: int(c) for name, c in (tree.get("update_counts") or {}).items()}
    if not topo_changed:
        return counts
    for man in manifests:
        host_tree = man["tree"]
        host_counts = host_tree.get("update_counts") or {}
        for name, schema in host_tree.get("metrics", {}).items():
            c = int(host_counts.get(name, schema["update_count"]))
            if c > counts.get(name, -1):
                counts[name] = c
    return counts


def _restore_collection(
    collection: Any,
    tree: Dict[str, Any],
    manifests: List[Dict[str, Any]],
    payloads: List[Dict[str, Any]],
    *,
    rank: int,
    world: int,
    saved_world: int,
    replicated: bool,
    persistent_only: bool,
) -> None:
    """Restore a collection: every member validated against its own saved schema
    first, the leaders' payloads loaded into every member, members re-aliased to
    their leader's tensors. A fused collection's next replay copies the restored
    tensors into its step buffers once."""
    if tree.get("kind") != "collection":
        raise CheckpointError("checkpoint was saved from a single Metric; restore into a Metric")
    saved_names = set(tree["metrics"])
    live_names = set(collection._modules)
    if saved_names != live_names:
        raise SchemaDriftError(
            "checkpoint metric names do not match the live collection:"
            f" missing live={sorted(saved_names - live_names)},"
            f" extra live={sorted(live_names - saved_names)}"
        )
    lives = {}
    for name in tree["metrics"]:
        lives[name] = _manifest.metric_schema(collection._modules[name])
        _manifest.validate_schema(lives[name], tree["metrics"][name], path=name, allow_subset=persistent_only)
    for group in tree["groups"]:  # the leaders' payloads load into every member
        _manifest.widen_counts(lives[group[0]], tree["metrics"][group[0]], payloads, f"{group[0]}/", group[0])
    update_counts = _member_update_counts(tree, manifests, topo_changed=world != saved_world)
    for group in tree["groups"]:
        leader_name = group[0]
        leader_schema = tree["metrics"][leader_name]
        leader = collection._modules[leader_name]
        for name in group:
            member = collection._modules[name]
            count = int(update_counts.get(name, leader_schema["update_count"]))
            if member is not leader and not leader_schema["children"]:
                # the member's states are the leader's: alias them, load nothing twice
                _restore.finalize_metric(member, count)
            else:
                _restore.assign_metric_state(
                    member, leader_schema, payloads, f"{leader_name}/",
                    rank=rank, world=world, saved_world=saved_world, replicated=replicated, update_count=count,
                )
            if member is not leader:
                # compute-group aliasing: members point at the leader's tensors
                for state in leader._defaults:
                    if state in leader_schema["states"]:
                        setattr(member, state, getattr(leader, state))
    collection._state_is_copy = False
