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
- **Stream order**: a tick may run on the tick thread or on the thread that calls
  ``flush``/``tick``/``close``, each on its own current stream. Each tick ends by
  recording an event on the target device's current stream; the next tick, and the
  caller's current stream on return from ``flush``, ``compute`` and ``close``, wait
  for it, so a reader on any stream sees every applied batch.
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
runs eagerly (the engines' plain version).

Hooks: with the obs gate on, each tick records an ``ingest_tick`` flight event and a
degraded tick a ``degrade`` event; an enabled health monitor sketches each batch's
enqueue-to-applied latency (``ingest/<queue>``) and each dropped batch's wait. A chain
captured for a new key adds a warm-manifest entry while
:mod:`~metrics_tpu_torch.serve.excache` records, and :func:`excache.prewarm
<metrics_tpu_torch.serve.excache.prewarm>` can capture a recorded key before the
first batch arrives. While :mod:`~metrics_tpu_torch.obs.flow` traces, each batch is a
flow minted at ``enqueue``, stamped at the tick's drain and launch (and with the
capture's host time at a miss), dispatched with the tick's end event, read back at
``compute``, and closed as degraded or dropped where the batch took those paths.
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
    _excache_module,
    _merge_inputs,
    _split_inputs,
    _static_key,
    _tensor_key,
    _warn_degrade_once,
    fusion_fallback_reason,
)
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import flight as _obs_flight
from metrics_tpu_torch.obs import flow as _obs_flow
from metrics_tpu_torch.obs import health as _health
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

    __slots__ = ("args", "kwargs", "rows", "t_enq", "ready", "flow")

    def __init__(self, args: Tuple, kwargs: Dict, rows: int, t_enq: float, ready: Any) -> None:
        self.args = args
        self.kwargs = kwargs
        self.rows = rows
        self.t_enq = t_enq
        self.ready = ready
        #: the trace flow minted at admission (``obs/flow.py``); None when not traced
        self.flow: Any = None


def _count_rows(args: Tuple, kwargs: Dict) -> int:
    """Leading dim of the first array input: the unit of ``coalesced_rows``."""
    for value in itertools.chain(args, kwargs.values()):
        shape = getattr(value, "shape", None)
        if shape:
            return int(shape[0])
    return 1


def _cuda_tensors(entry: _Entry) -> List[torch.Tensor]:
    return [v for v in itertools.chain(entry.args, entry.kwargs.values()) if isinstance(v, torch.Tensor) and v.is_cuda]


def _state_device(target: Any) -> Optional[torch.device]:
    """The CUDA device of the target's (or its first member's) states; None off the card."""
    from metrics_tpu_torch.core.collections import MetricCollection

    metrics = target.values(copy_state=False) if isinstance(target, MetricCollection) else [target]
    for m in metrics:
        device = getattr(m, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            return device
    return None


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
        #: the traced flows the current tick's chain launched (under the tick lock)
        self._launched_flows: List[Any] = []
        self._last_apply_t = time.monotonic()
        #: the event the last tick recorded on the target device's stream (on the card)
        self._applied: Any = None

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
        if _obs._ENABLED and _obs_flow._TRACER is not None:
            entry.flow = _obs_flow._TRACER.mint(
                self.name, id(self.target), rows=entry.rows,
                streams=_obs_flow.host_stream_ids(kwargs.get("stream_ids")),
            )
        with self._admit:
            if self._ring.full:
                if self.backpressure == "raise":
                    raise IngestBackpressureError(
                        f"IngestQueue {self.name!r} is full ({self._ring.capacity} pending batches) and"
                        " backpressure='raise'; flush(), widen capacity, or pick 'block'/'drop_oldest'"
                    )
                if self.backpressure == "drop_oldest":
                    evicted = self._ring.pop_oldest()
                    if evicted is not None:
                        self.stats["dropped"] += 1
                        self._note_dropped([evicted], "backpressure")
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
        self._wait_applied()
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
        first, unless ``max_staleness_s`` is set and the last tick is recent enough. The
        flush takes the tick lock even with an empty ring: a tick thread may have drained
        batches it has not applied yet."""
        self._reraise()
        stale_ok = (
            self.max_staleness_s is not None and (time.monotonic() - self._last_apply_t) <= self.max_staleness_s
        )
        if not stale_ok:
            self.flush()
        else:
            self._wait_applied()
        if _obs._ENABLED and _obs_flow._TRACER is not None:
            # the readback stage: this read's host transfer, stamped onto the
            # completed flows it serves
            t0 = time.perf_counter()
            value = self.target.compute(**kwargs)
            trc = _obs_flow._TRACER
            if trc is not None:
                trc.note_readback(self.name, time.perf_counter() - t0)
            return value
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
                    self._note_dropped(discarded, "close")
        self._wait_applied()
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

    def _note_dropped(self, entries: List[_Entry], site: str) -> None:
        """Count dropped batches; each one's wait goes to the health sketch
        ``ingest.dropped_latency/<queue>``, and its traced flow closes as dropped."""
        now = time.monotonic()
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "dropped", len(entries))
            if _obs_flight._RING is not None:
                for e in entries:
                    _obs_flight.record("flow_dropped", queue=self.name, site=site, rows=e.rows,
                                       waited_us=round((now - e.t_enq) * 1e6, 1),
                                       flow_id=None if e.flow is None else e.flow.flow_id)
        mon = _health._MONITOR
        if mon is not None:
            for e in entries:
                mon.observe_latency("ingest.dropped_latency", self.name, now - e.t_enq)
        trc = _obs_flow._TRACER
        if trc is not None:
            for e in entries:
                if e.flow is not None:
                    trc.close_dropped(e.flow)

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

    def _wait_applied(self) -> None:
        """Order this thread's current stream after the last tick's work."""
        applied = self._applied
        if applied is not None:
            torch.cuda.current_stream(applied[1]).wait_event(applied[0])

    def _apply(self, entries: List[_Entry]) -> None:
        """One tick: order after the last tick and the producers' work, chain the
        batches, and record where the tick's work ends. Traced flows are dispatched
        with that event when the chain launched them; the rest close here."""
        self._wait_applied()
        trc = _obs_flow._TRACER if _obs._ENABLED else None
        flows = [e.flow for e in entries if e.flow is not None] if trc is not None else []
        if flows:
            trc.stamp_drain(flows)
        self._launched_flows = []
        ok = False
        try:
            self._apply_ordered(entries)
            ok = True
        finally:
            event = None
            device = _state_device(self.target)
            if device is not None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                self._applied = (event, device)
            if flows:
                self._end_flows(trc, flows, event, ok)

    def _end_flows(self, trc: Any, flows: List[Any], event: Any, ok: bool) -> None:
        """The tick's flows: those the chain launched go to the completion watcher
        with the tick's event; the others (an eager-only plan) close now; after a
        tick that raised, every open one closes as degraded (no orphaned flows)."""
        if not ok:
            for fl in flows:
                if not fl.closed:
                    trc.close_degraded(fl)
            return
        launched = [fl for fl in self._launched_flows if not fl.closed]
        if launched:
            trc.dispatch(launched, event)
        leftovers = [fl for fl in flows if not fl.dispatched and not fl.closed]
        if leftovers:
            trc.close_now(leftovers)

    def _apply_ordered(self, entries: List[_Entry]) -> None:
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
                self._finish_tick(entries, 0)
                return
        try:
            self._apply_coalesced(entries)
        except Exception as err:  # noqa: BLE001 - the synchronous path is always correct
            # the chain failed before its replay wrote anything (a capture that failed,
            # a broken key): the live state is as it was
            if self.stats["launches"] != launches_before:
                raise
            self._degrade(entries, err)
        self._finish_tick(entries, self.stats["launches"] - launches_before)

    def _finish_tick(self, entries: List[_Entry], launched: int) -> None:
        now = time.monotonic()
        rows = sum(e.rows for e in entries)
        self.stats["ticks"] += 1
        self.stats["coalesced_rows"] += rows
        self._last_apply_t = now
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "ticks")
            _obs.REGISTRY.inc("ingest", "coalesced_rows", rows)
            if _obs_flight._RING is not None:
                _obs_flight.record("ingest_tick", queue=self.name, entries=len(entries), rows=rows, launches=launched)
        mon = _health._MONITOR
        if mon is not None:
            for e in entries:
                mon.observe_latency("ingest", self.name, now - e.t_enq)

    # ----------------------------------------------------- degradation path

    def _degrade(self, entries: List[_Entry], err: Exception) -> None:
        """Apply the batches through the public ``update``: no rows lost."""
        self.stats["degrades"] += 1
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "degrades")
            if _obs_flight._RING is not None:
                _obs_flight.record("degrade", site="ingest.tick", queue=self.name, entries=len(entries),
                                   error=type(err).__name__)
        _warn_degrade_once("ingest.tick", err, "the pending batches were applied synchronously (no rows lost).")
        trc = _obs_flow._TRACER if _obs._ENABLED else None
        for e in entries:
            # the batch's flow is the ambient one meanwhile: the fused engine charges
            # the synchronous re-apply to it and mints none of its own
            traced = trc is not None and e.flow is not None
            if traced:
                _obs_flow._push(e.flow)
            try:
                self.target.update(*e.args, **e.kwargs)
            except BaseException as apply_err:  # noqa: BLE001 - keep the later batches flowing
                # the outcome a synchronous caller would have seen: stash the first
                if self._error is None:
                    self._error = apply_err
            finally:
                if traced:
                    _obs_flow._pop()
                    if not e.flow.closed:
                        trc.close_degraded(e.flow)

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
        trc = _obs_flow._TRACER if _obs._ENABLED else None
        for _label, leader in eager:
            self.stats["eager_entries"] += len(entries)
            for e in entries:
                traced = trc is not None and e.flow is not None
                if traced:
                    _obs_flow._push(e.flow)
                try:
                    leader.update(*e.args, **(leader._filter_kwargs(**e.kwargs) if is_collection else e.kwargs))
                except BaseException as err:  # noqa: BLE001 - a rejected batch (nan_policy): stash, go on
                    if self._error is None:
                        self._error = err
                finally:
                    if traced:
                        _obs_flow._pop()
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

    def _chain_step(
        self, chain: List[Tuple[str, Any]], inputs: List[Tuple[Tuple, Dict]], filter_kwargs: bool
    ) -> Tuple[Tuple, Dict[str, Any], List[List[torch.Tensor]], Callable[[], Callable], bool]:
        """``(key, states, dyn_lists, make_step, uniform)`` of a chain over the batches'
        ``(args, kwargs)``: what a tick runs, and what a warm-manifest prewarm captures."""
        device = chain[0][1].device
        dyn_lists: List[List[torch.Tensor]] = []
        specs: List[Tuple[Any, tuple]] = []
        for args, kwargs in inputs:
            dyn, spec = _split_inputs(args, kwargs, device)
            dyn_lists.append(dyn)
            specs.append(spec)
        n = len(inputs)
        uniform = n > 1 and self._uniform_signature(dyn_lists, specs)
        if uniform:
            sig: Tuple = ("chain", n, _tensor_key(dyn_lists[0]), _static_key(specs[0]))
            step_specs = [specs[0]] * n
        else:
            sig = tuple((_tensor_key(d), _static_key(s)) for d, s in zip(dyn_lists, specs))
            step_specs = specs
        states = {label: m.state_pytree() for label, m in chain}
        key = (tuple((label, id(m)) for label, m in chain), _tensor_key(states), sig)
        return key, states, dyn_lists, lambda: self._build_step(chain, step_specs, filter_kwargs), uniform

    def _launch_chain(self, chain: List[Tuple[str, Any]], entries: List[_Entry], filter_kwargs: bool) -> None:
        device = chain[0][1].device
        n = len(entries)
        trc = _obs_flow._TRACER if _obs._ENABLED else None
        flows = [e.flow for e in entries if e.flow is not None] if trc is not None else []
        if flows:
            trc.stamp_launch(flows)
        key, states, dyn_lists, make_step, uniform = self._chain_step(
            chain, [(e.args, e.kwargs) for e in entries], filter_kwargs
        )
        misses = self.step_stats.get("cache_misses", 0)
        first = key not in self._steps.steps and key not in self._steps.broken
        out = self._steps.call(
            key,
            make_step,
            states,
            [dyn_lists],
            "this signature's batches are applied synchronously from now on.",
        )
        if first and out is not None:
            _excache = _excache_module()
            if _excache is not None and _excache.recording():
                _excache.record_ingest_compile(self, chain, uniform, entries, key)
        if out is None:
            raise RuntimeError(f"IngestQueue {self.name!r}: the chained step of this signature failed")
        if self.step_stats["cache_misses"] != misses:
            if device.type == "cuda":
                self.stats["capture_entries"] += n
            if flows:
                trc.add_compile(flows, self._steps.last_compile_us)
        self._launched_flows = flows
        new_states, _ = out
        self.stats["launches"] += 1
        for label, m in chain:
            m._load_state({k: v for k, v in new_states[label].items() if getattr(m, k) is not v})
            m._update_count += n
            m._computed = None
            if _obs._ENABLED:
                _obs.REGISTRY.inc(type(m).__name__, "updates", n)
        if _obs._ENABLED:
            _obs.REGISTRY.inc("ingest", "launches")
            _obs.REGISTRY.inc("ingest", "dispatches")


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
