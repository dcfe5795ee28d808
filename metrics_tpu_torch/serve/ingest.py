"""Async ingestion: a host-side staging ring and one CUDA-graph replay a tick
(counterpart of ``metrics_tpu/serve/ingest.py``).

The synchronous path pays one host dispatch per ``update()``. This module takes
arrival off the accumulation path:

- :meth:`IngestQueue.enqueue` appends the batch (args and kwargs, ``stream_ids``
  included) to a bounded ring (:class:`~metrics_tpu_torch.obs.ring.Ring`) and returns.
  It does no device work: it records a CUDA event on the producer's current stream,
  which the tick waits for before it reads the batch.
- A background tick thread drains what is pending and applies it: the drained
  batches are chained through the chainable leaders' pure ``local_update``, in
  enqueue order, and on the card that chain is **one CUDA-graph replay**, captured
  once per key (leaders, state shapes and dtypes, and the batches' signature: the
  count and entry 0's shapes, dtypes and static inputs when all entries share them,
  else each entry's), through the fused engine's
  :class:`~metrics_tpu_torch.core.fused.StepCache`. Chaining, never concatenating
  rows, keeps each batch's own shapes and reduction order, so the result is
  **bit-equal** to calling ``update`` on the same batches in the same order.

Contract:

- **Bit-equal**: after ``flush()`` the target's state is bitwise the state of
  synchronous ``target.update`` calls on the same batches in the same order.
- **Aliasing**: the queue keeps the caller's tensors, not copies. A tensor handed
  to ``enqueue`` must not be written in place before its batch is applied (after
  ``flush()``, or when ``depth`` shows it drained).
- **Bounded backpressure**: a full ring blocks the producer (``"block"``), evicts
  the oldest pending batch (``"drop_oldest"``, counted in ``stats["dropped"]``) or
  raises :class:`IngestBackpressureError` (``"raise"``).
- **Staleness bound on reads**: :meth:`IngestQueue.compute` flushes first, unless
  ``max_staleness_s`` allows the last ticked state. ``ckpt.save_checkpoint`` flushes
  any active queue of the object it saves (:func:`flush_for`).
- **Clean shutdown**: ``close(drain=True)`` and the context manager's exit stop the
  thread and apply what is pending.
- **Degradation**: a failed tick (an ``ingest.tick`` fault, a failed capture or
  replay) applies its batches through the public ``update``, one by one: no row is
  lost; ``stats["degrades"]`` counts it.

A target (or compute-group leader) whose update cannot be chained (host-side
updates, list or ``CatBuffer`` states, ``nan_policy``, wrappers: the fused engine's
:func:`~metrics_tpu_torch.core.fused.fusion_fallback_reason`) is still served: its
batches are applied eagerly inside the tick, one update each. On the CPU the chain
runs eagerly (the engines' plain version). The flow-tracing, flight and health hooks
belong to the observability slice; the executable-cache recording to the serving
slice.
"""
import itertools
import threading
from contextlib import nullcontext
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.core.fused import (
    StepCache,
    _merge_inputs,
    _split_inputs,
    _static_key,
    _tensor_key,
    _warn_degrade_once,
    fusion_fallback_reason,
)
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.obs.ring import Ring
from metrics_tpu_torch.utils.concurrency import locked_by, thread_role

__all__ = ["IngestBackpressureError", "IngestQueue", "active_queues", "flush_for", "max_queue_depth"]

#: every live, unclosed queue (weakly held), for flush-before-save
_ACTIVE: "weakref.WeakSet[IngestQueue]" = weakref.WeakSet()

_NAME_SEQ = itertools.count()

_BACKPRESSURE_POLICIES = ("block", "drop_oldest", "raise")


class IngestBackpressureError(RuntimeError):
    """The ring is full and the policy refuses the batch: at once under
    ``backpressure="raise"``, after ``block_timeout_s`` under ``"block"``."""


class _Entry:
    """One enqueued batch: the inputs as given, the event that orders the tick after
    the producer's work on them, and arrival bookkeeping."""

    __slots__ = ("args", "kwargs", "rows", "t_enq", "ready")

    def __init__(self, args: Tuple, kwargs: Dict, rows: int, t_enq: float, ready: Any) -> None:
        self.args = args
        self.kwargs = kwargs
        self.rows = rows
        self.t_enq = t_enq
        self.ready = ready


def _count_rows(args: Tuple, kwargs: Dict) -> int:
    """Leading dim of the first array input: the unit of ``coalesced_rows``."""
    for value in itertools.chain(args, kwargs.values()):
        shape = getattr(value, "shape", None)
        if shape:
            return int(shape[0])
    return 1


def _cuda_tensors(entry: _Entry) -> List[torch.Tensor]:
    return [v for v in itertools.chain(entry.args, entry.kwargs.values()) if isinstance(v, torch.Tensor) and v.is_cuda]


def _ready_event(args: Tuple, kwargs: Dict) -> Any:
    """A CUDA event on the current stream of the first CUDA tensor input's device
    (None without one): the point the producer's work on the batch reached."""
    for value in itertools.chain(args, kwargs.values()):
        if isinstance(value, torch.Tensor) and value.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(value.device))
            return event
    return None


class IngestQueue:
    """Bounded async staging for a ``Metric`` or ``MetricCollection``.

    Args:
        target: the metric or collection every batch goes to. The queue never copies
            it, so a direct read of ``target`` needs :meth:`flush` first.
        capacity: ring size (pending batches, not rows).
        tick_interval_s: the background thread's sleep between drains; an enqueue
            also wakes it.
        backpressure: ``"block"`` | ``"drop_oldest"`` | ``"raise"``.
        block_timeout_s: the longest a blocked producer waits.
        max_staleness_s: when set, :meth:`compute` may read the last ticked state if
            the newest tick is at most this old; None flushes before every read.
        max_coalesce: most batches chained into one replay; a deeper backlog drains
            in successive replays. Bounds the graph's length and the number of keys.
        name: label of the queue (counters, thread name).
        start: start the tick thread (False: tick by :meth:`flush`/:meth:`tick`).

    ``stats``: ``enqueued``, ``ticks``, ``launches`` (chained replays),
    ``coalesced_rows``, ``dropped``, ``degrades``, ``eager_entries``, ``max_depth``,
    and ``capture_entries`` (the batches run by captures' warm-ups, each of which
    ran their kernels once more). ``step_stats`` are the chain's
    :class:`~metrics_tpu_torch.core.fused.StepCache` counts (``cache_misses`` are
    captures).
    """

    def __init__(
        self,
        target: Any,
        *,
        capacity: int = 1024,
        tick_interval_s: float = 0.005,
        backpressure: str = "block",
        block_timeout_s: float = 30.0,
        max_staleness_s: Optional[float] = None,
        max_coalesce: int = 128,
        name: Optional[str] = None,
        start: bool = True,
    ) -> None:
        if backpressure not in _BACKPRESSURE_POLICIES:
            raise ValueError(f"backpressure must be one of {_BACKPRESSURE_POLICIES}, got {backpressure!r}")
        if max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {max_coalesce}")
        self.target = target
        self.name = name or f"{type(target).__name__}-{next(_NAME_SEQ)}"
        self.backpressure = backpressure
        self.block_timeout_s = float(block_timeout_s)
        self.max_staleness_s = max_staleness_s
        self.max_coalesce = int(max_coalesce)
        self.tick_interval_s = float(tick_interval_s)

        self._ring = Ring(capacity)
        # producer side: admission checks and the block policy
        self._admit = threading.Condition(threading.Lock())
        # one tick at a time: the background thread, flush() and close()
        self._tick_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        #: the first error of an applied batch; re-raised at the next host call
        self._error: Optional[BaseException] = None

        self.stats: Dict[str, int] = {
            "enqueued": 0,
            "ticks": 0,
            "launches": 0,
            "coalesced_rows": 0,
            "dropped": 0,
            "degrades": 0,
            "eager_entries": 0,
            "max_depth": 0,
            "capture_entries": 0,
        }
        self.step_stats: Dict[str, int] = {}
        self._steps = StepCache("ingest", self.step_stats)
        self._last_apply_t = time.monotonic()

        self._thread: Optional[threading.Thread] = None
        _ACTIVE.add(self)
        if start:
            self._thread = threading.Thread(target=self._loop, name=f"tm-ingest/{self.name}", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- producer

    @property
    def depth(self) -> int:
        """Batches staged and not yet applied."""
        return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    def enqueue(self, *args: Any, **kwargs: Any) -> None:
        """Stage one batch and return, with no device work.

        Takes what ``target.update`` takes (``stream_ids=`` for a fleet). The tensors
        are kept, not copied: do not write them in place before they are applied.
        """
        if self._closed:
            raise RuntimeError(f"IngestQueue {self.name!r} is closed")
        self._reraise()
        if _fault._SCHEDULE is not None:
            _fault.fire("ingest.enqueue", queue=self.name, depth=len(self._ring))
        entry = _Entry(args, kwargs, _count_rows(args, kwargs), time.monotonic(), _ready_event(args, kwargs))
        with self._admit:
            if self._ring.full:
                if self.backpressure == "raise":
                    raise IngestBackpressureError(
                        f"IngestQueue {self.name!r} is full ({self._ring.capacity} pending batches) and"
                        " backpressure='raise'; flush(), widen capacity, or pick 'block'/'drop_oldest'"
                    )
                if self.backpressure == "drop_oldest":
                    if self._ring.pop_oldest() is not None:
                        self.stats["dropped"] += 1
                        self._note_dropped(1)
                else:  # block
                    deadline = time.monotonic() + self.block_timeout_s
                    while self._ring.full:
                        self._wake.set()
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._admit.wait(remaining):
                            raise IngestBackpressureError(
                                f"IngestQueue {self.name!r}: producer blocked > {self.block_timeout_s}s on a full"
                                " ring (is the tick thread running?)"
                            )
                        self._reraise()
            self._ring.append(entry)
            self.stats["enqueued"] += 1
            depth = len(self._ring)
            if depth > self.stats["max_depth"]:
                self.stats["max_depth"] = depth
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "enqueued")
        if self._thread is not None:
            self._wake.set()

    # ------------------------------------------------------------- reading

    def flush(self) -> None:
        """Apply everything pending; on return the target's state is exact."""
        with self._tick_lock:
            self._run_ticks()
        self._reraise()

    def tick(self, limit: Optional[int] = None) -> int:
        """One bounded drain and apply (at most ``min(limit, max_coalesce)`` batches,
        one replay); returns the number applied. For an external ticker that shares
        its budget over several queues. Errors are stashed as in the background tick."""
        budget = self.max_coalesce if limit is None else min(int(limit), self.max_coalesce)
        if budget < 1:
            return 0
        with self._tick_lock:
            with self._admit:
                entries = self._ring.drain(limit=budget)
                if entries:
                    self._admit.notify_all()
            if not entries:
                return 0
            try:
                self._apply(entries)
            except BaseException as err:  # noqa: BLE001 - stashed like _run_ticks
                if self._error is None:
                    self._error = err
        return len(entries)

    def compute(self, **kwargs: Any) -> Any:
        """``target.compute()`` within the staleness bound: pending batches are applied
        first, unless ``max_staleness_s`` is set and the last tick is recent enough."""
        self._reraise()
        if len(self._ring):
            stale_ok = (
                self.max_staleness_s is not None and (time.monotonic() - self._last_apply_t) <= self.max_staleness_s
            )
            if not stale_ok:
                self.flush()
        return self.target.compute(**kwargs)

    # ------------------------------------------------------------ lifecycle

    def close(self, drain: bool = True) -> None:
        """Stop the tick thread; ``drain=True`` applies what is pending, ``drain=False``
        discards it (counted in ``stats['dropped']``)."""
        if self._closed:
            return
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, self.block_timeout_s))
            self._thread = None
        with self._tick_lock:
            if drain:
                self._run_ticks()
            else:
                discarded = self._ring.drain()
                if discarded:
                    self.stats["dropped"] += len(discarded)
                    self._note_dropped(len(discarded))
        self._closed = True
        _ACTIVE.discard(self)
        self._reraise()

    def __enter__(self) -> "IngestQueue":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close(drain=True)

    def _reraise(self) -> None:
        err = self._error
        if err is not None:
            self._error = None
            raise err

    def _note_dropped(self, n: int) -> None:
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "dropped", n)

    # ------------------------------------------------------------- ticking

    @thread_role("ingest-tick")
    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.tick_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            if not len(self._ring):
                continue
            with self._tick_lock:
                self._run_ticks()

    @locked_by("IngestQueue._tick_lock")
    def _run_ticks(self) -> None:
        """Drain and apply until the ring is empty. Never raises: a failure degrades
        to the synchronous path, and an error of an applied batch is stashed for the
        next host call (``enqueue``/``flush``/``compute``/``close``)."""
        while True:
            with self._admit:
                entries = self._ring.drain(limit=self.max_coalesce)
                if entries:
                    self._admit.notify_all()
            if not entries:
                return
            try:
                self._apply(entries)
            except BaseException as err:  # noqa: BLE001 - see the docstring
                if self._error is None:
                    self._error = err
                return

    def _apply(self, entries: List[_Entry]) -> None:
        """One tick: order after the producers' work, then chain the batches."""
        for e in entries:
            if e.ready is not None:
                tensors = _cuda_tensors(e)
                stream = torch.cuda.current_stream(tensors[0].device)
                stream.wait_event(e.ready)
                for t in tensors:  # the producer's stream may reuse the memory only after this tick's use
                    t.record_stream(stream)
        launches_before = self.stats["launches"]
        if _fault._SCHEDULE is not None:
            try:
                _fault.fire("ingest.tick", queue=self.name, entries=len(entries))
            except _fault.InjectedFaultError as err:
                self._degrade(entries, err)
                self._finish_tick(entries)
                return
        try:
            self._apply_coalesced(entries)
        except Exception as err:  # noqa: BLE001 - the synchronous path is always correct
            # the chain failed before its replay wrote anything (a capture that failed,
            # a broken key): the live state is as it was
            if self.stats["launches"] != launches_before:
                raise
            self._degrade(entries, err)
        self._finish_tick(entries)

    def _finish_tick(self, entries: List[_Entry]) -> None:
        rows = sum(e.rows for e in entries)
        self.stats["ticks"] += 1
        self.stats["coalesced_rows"] += rows
        self._last_apply_t = time.monotonic()
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "ticks")
            _obs.REGISTRY.inc("ingest", "coalesced_rows", rows)

    # ----------------------------------------------------- degradation path

    def _degrade(self, entries: List[_Entry], err: Exception) -> None:
        """Apply the batches through the public ``update``: no rows lost."""
        self.stats["degrades"] += 1
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "degrades")
        _warn_degrade_once("ingest.tick", err, "the pending batches were applied synchronously (no rows lost).")
        for e in entries:
            try:
                self.target.update(*e.args, **e.kwargs)
            except BaseException as apply_err:  # noqa: BLE001 - keep the later batches flowing
                # the outcome a synchronous caller would have seen: stash the first
                if self._error is None:
                    self._error = apply_err

    # ------------------------------------------------------- coalesced path

    def _plan(self) -> Tuple[List[Tuple[str, Any]], List[Tuple[str, Any]], bool]:
        """``(chainable leaders, eager leaders, is_collection)`` as ``(label, metric)``
        pairs: the target itself, or one leader per compute group of a collection."""
        from metrics_tpu_torch.core.collections import MetricCollection

        if not isinstance(self.target, MetricCollection):
            if fusion_fallback_reason(self.target, (self.target,)) is None:
                return [("__target__", self.target)], [], False
            return [], [("__target__", self.target)], False
        coll = self.target
        if coll._groups_checked:
            coll._split_diverged_members()
        groups = [list(cg) for cg in coll._groups.values()] or [[str(k)] for k in coll._modules]
        chain: List[Tuple[str, Any]] = []
        eager: List[Tuple[str, Any]] = []
        device = None
        for names in groups:
            leader = coll._modules[names[0]]
            reason = fusion_fallback_reason(leader, [coll._modules[n] for n in names])
            if reason is None:
                device = device or leader.device
                reason = None if leader.device == device else "on another device than the chain"
            (chain if reason is None else eager).append((names[0], leader))
        return chain, eager, True

    def _apply_coalesced(self, entries: List[_Entry]) -> None:
        """The chainable leaders advance by one chained step over every batch; the
        others take one eager update a batch, inside the tick."""
        chain, eager, is_collection = self._plan()
        if chain:
            device = chain[0][1].device
            with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
                self._launch_chain(chain, entries, filter_kwargs=is_collection)
        for _label, leader in eager:
            self.stats["eager_entries"] += len(entries)
            for e in entries:
                try:
                    leader.update(*e.args, **(leader._filter_kwargs(**e.kwargs) if is_collection else e.kwargs))
                except BaseException as err:  # noqa: BLE001 - a rejected batch (nan_policy): stash, go on
                    if self._error is None:
                        self._error = err
        if is_collection:
            self.target._state_is_copy = False
            self.target._compute_groups_create_state_ref()

    @staticmethod
    def _build_step(chain: List[Tuple[str, Any]], specs: List[Tuple[Any, tuple]], filter_kwargs: bool) -> Callable:
        """The pure chained step: every batch, in order, through every leader's
        ``local_update``."""

        def step(states: Dict[str, Any], dyn_lists: List[List[torch.Tensor]]) -> Tuple[Dict[str, Any], None]:
            states = dict(states)
            for dyn, spec in zip(dyn_lists, specs):
                a, k = _merge_inputs(dyn, spec)
                for label, m in chain:
                    states[label] = m.local_update(states[label], *a, **(m._filter_kwargs(**k) if filter_kwargs else k))
            return states, None

        return step

    @staticmethod
    def _uniform_signature(dyn_lists: List[List[torch.Tensor]], specs: List[Tuple[Any, tuple]]) -> bool:
        """Every entry has entry 0's structure, shapes, dtypes, devices and static
        inputs: the steady state, keyed by entry 0 and the count."""
        key0, static0 = _tensor_key(dyn_lists[0]), _static_key(specs[0])
        try:
            return all(_tensor_key(d) == key0 and _static_key(s) == static0 for d, s in zip(dyn_lists[1:], specs[1:]))
        except Exception:  # noqa: BLE001 - an exotic static __eq__: key each entry
            return False

    def _launch_chain(self, chain: List[Tuple[str, Any]], entries: List[_Entry], filter_kwargs: bool) -> None:
        device = chain[0][1].device
        dyn_lists: List[List[torch.Tensor]] = []
        specs: List[Tuple[Any, tuple]] = []
        for e in entries:
            dyn, spec = _split_inputs(e.args, e.kwargs, device)
            dyn_lists.append(dyn)
            specs.append(spec)
        n = len(entries)
        if n > 1 and self._uniform_signature(dyn_lists, specs):
            sig: Tuple = ("chain", n, _tensor_key(dyn_lists[0]), _static_key(specs[0]))
            step_specs = [specs[0]] * n
        else:
            sig = tuple((_tensor_key(d), _static_key(s)) for d, s in zip(dyn_lists, specs))
            step_specs = specs
        states = {label: m.state_pytree() for label, m in chain}
        key = (tuple((label, id(m)) for label, m in chain), _tensor_key(states), sig)
        misses = self.step_stats.get("cache_misses", 0)
        out = self._steps.call(
            key,
            lambda: self._build_step(chain, step_specs, filter_kwargs),
            states,
            [dyn_lists],
            "this signature's batches are applied synchronously from now on.",
        )
        if out is None:
            raise RuntimeError(f"IngestQueue {self.name!r}: the chained step of this signature failed")
        if device.type == "cuda" and self.step_stats["cache_misses"] != misses:
            self.stats["capture_entries"] += n
        new_states, _ = out
        self.stats["launches"] += 1
        for label, m in chain:
            m._load_state({k: v for k, v in new_states[label].items() if getattr(m, k) is not v})
            m._update_count += n
            m._computed = None
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "launches")


# --------------------------------------------------------------- module API


def active_queues() -> List[IngestQueue]:
    """Every live, unclosed queue."""
    return [q for q in list(_ACTIVE) if not q._closed]


def flush_for(target: Any) -> int:
    """Flush every active queue of ``target``; returns how many.
    ``ckpt.save_checkpoint`` calls it before it snapshots."""
    n = 0
    for q in active_queues():
        if q.target is target:
            q.flush()
            n += 1
    return n


def max_queue_depth() -> int:
    """The deepest backlog over the active queues."""
    return max((q.depth for q in active_queues()), default=0)
