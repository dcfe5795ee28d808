"""tmflow: end-to-end causal request tracing with per-tenant attribution
(counterpart of ``metrics_tpu/obs/flow.py``).

The serving stack's telemetry is per subsystem: obs counters, flight events and health
sketches each see one hop. This module composes them: one **flow ID** minted per batch
at ``IngestQueue.enqueue()`` (and per fused-collection or fleet ``update()``/``forward()``
while tracing is on) follows the batch through the tick's coalescing, the capture or
replay of its step, device completion and the checkpoint that captured it, so that
"why was THIS batch slow?" and "which tenant eats the tick budget?" have answers.

Flow lifecycle (each stage in µs on the ``perf_counter`` timebase of the flight
recorder)::

    enqueue ──queue_wait──► drain ──coalesce──► launch ┬─compile─┐
                                                       └─launch──┴► dispatch
    dispatch ──device──► CUDA event complete    compute() ──readback──► host

- ``queue_wait``: staged in the ingest ring (0 for synchronous flows);
- ``coalesce``: tick planning: the signature split, the state gather, the key lookup;
- ``compile``: the host time of a :class:`~metrics_tpu_torch.core.fused.StepCache`
  miss, the capture of the step's CUDA graph and its warm-up (0 on a hit);
- ``launch``: the host dispatch of the replay, compile excluded;
- ``device``: from the host dispatch to the completion of the CUDA event that marks
  the end of the tick's work (the ingest queue's own per-tick event; one event after
  the replay of a synchronous fused step), observed by a **completion watcher**
  thread that polls ``event.query()``, so that host dispatch time and device time
  split cleanly. A flow closes at once when its event is already complete or its
  tensors are on the CPU;
- ``readback``: the ``compute()`` host transfer, stamped onto the queue's completed
  flows that no read has served yet.

Fan-in: one coalesced replay serves many flows; every flow the same launch dispatched
shares a ``tick`` id, rendered as one launch slice in the Chrome trace export (flow
arrows from each enqueue slice) and as a ``tick`` span holding one link per flow in
:func:`export_spans`.

Faults: a CUDA error raised by an event query is counted (``flow/device_errors``),
recorded in the flight ring (``flow_fault``) and closes the flows as degraded; an
event still incomplete at the watcher's deadline does the same under
``flow/watch_timeouts``. Events are recorded outside any graph capture, so the watcher
never queries an event of a capturing stream.

Gate (the single-boolean rule of ``registry.py``): every call site lives inside an
existing ``if registry._ENABLED:`` block and also checks ``flow._TRACER is not None``.
Nothing here allocates, locks or runs before :func:`enable` builds the tracer, and
sampling (``sample_rate=N``) traces 1 in N flows so that production can keep it on.
Flow events ride the flight ring, flow latencies feed the health sketches
(``flow/<queue>`` end to end, ``flow/<queue>/<stream>`` per tenant,
``flow_stage/<stage>`` per stage), and ``obs.prom.render`` exposes the ``tm_flow_*``
families off the same state.

Deviations from the JAX package: :func:`enable` takes the ``device`` of the health
monitor it creates (the port's monitor keeps its sketches on the card unless told
otherwise), and ``stream_ids`` held on the card are not read at enqueue (that would be
a device sync on the producer's thread): such flows carry no tenant ids.
"""
import hashlib
import itertools
import queue as _queue_mod
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.obs import flight as _flight
from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _reg
from metrics_tpu_torch.utils.concurrency import locked_by, thread_role

__all__ = [
    "FlowTracer",
    "active",
    "current",
    "disable",
    "drain_for_ckpt",
    "enable",
    "export_spans",
    "records",
    "stats",
    "tracer",
    "validate_spans",
    "wait_idle",
]

#: the watcher's poll interval while events are outstanding: it starts short and
#: doubles up to the longest, so that the device stamp is within it of completion
_POLL_MIN_S = 5e-5
_POLL_MAX_S = 1e-3

#: seconds a dispatched tick's event may stay incomplete before its flows close degraded
WATCH_TIMEOUT_S = 60.0

#: ordered stage vocabulary of the latency breakdown (µs each)
STAGES = ("queue_wait", "coalesce", "compile", "launch", "device", "readback")

#: the tracer itself. ``None`` == tracing off == nothing allocated; hot paths
#: gate on ``_TRACER is not None`` inside their existing obs-enabled blocks.
_TRACER: Optional["FlowTracer"] = None

_ID_SEQ = itertools.count(1)

#: thread-local ambient-flow stack: the degraded/eager re-entry paths push the
#: originating flow here so the fused/fleet engines attribute their events to
#: it instead of minting a second flow for the same batch.
_TLS = threading.local()


def current() -> Optional["_Flow"]:
    """The ambient flow of this thread (innermost), or ``None``."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def _push(fl: "_Flow") -> None:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(fl)


def _pop() -> None:
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack.pop()


def host_stream_ids(stream_ids: Any) -> Tuple[int, ...]:
    """Best-effort unique host ints from a ``stream_ids=`` argument.

    A tensor on the card, a tensor under a transform, and exotic dtypes all give
    ``()``: the attribution is telemetry, never a correctness dependency, and never
    a device sync.
    """
    if stream_ids is None:
        return ()
    try:
        import numpy as np

        if isinstance(stream_ids, torch.Tensor):
            if stream_ids.device.type != "cpu" or torch._C._are_functorch_transforms_active():
                return ()
            stream_ids = stream_ids.numpy()
        arr = np.asarray(stream_ids)
        if arr.dtype.kind not in ("i", "u") or arr.ndim != 1 or not arr.size:
            return ()
        return tuple(int(s) for s in np.unique(arr)[:64])
    except Exception:  # noqa: BLE001 — attribution is best-effort by contract
        return ()


def _rows_of(args: Tuple, kwargs: Dict) -> int:
    for value in itertools.chain(args, kwargs.values()):
        shape = getattr(value, "shape", None)
        if shape:
            try:
                return int(shape[0])
            except Exception:  # noqa: BLE001 — symbolic dims
                return 1
    return 1


def device_done_event(device: Any) -> Any:
    """A CUDA event recorded now on ``device``'s current stream: the end of the work
    a synchronous step queued there. None off the card, and on a thread whose stream
    is capturing (an event recorded there would belong to the graph)."""
    if device is None or getattr(device, "type", None) != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Flow:
    """One traced batch: identity, µs stamps, and attribution fields.

    Mutated only through :class:`FlowTracer` methods (pre-dispatch stamps run
    on the producing thread, the close on the watcher thread, its tables under the
    tracer lock; ``closed`` flips exactly once).
    """

    __slots__ = (
        "trace_id", "seq", "queue", "target_id", "sync", "rows", "streams",
        "tick", "t_enq", "t_drain", "t_launch", "t_dispatch", "t_device",
        "compile_us", "readback_us", "degraded", "dropped", "dispatched",
        "closed",
    )

    def __init__(self, trace_id: str, seq: int, queue: str, target_id: int,
                 sync: bool, rows: int, streams: Tuple[int, ...]) -> None:
        self.trace_id = trace_id
        self.seq = seq
        self.queue = queue
        self.target_id = target_id
        self.sync = sync
        self.rows = rows
        self.streams = streams
        self.tick: Optional[int] = None
        now = _flight._now_us()
        self.t_enq = now
        # synchronous flows never stage: queue_wait/coalesce start collapsed
        self.t_drain: Optional[float] = now if sync else None
        self.t_launch: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_device: Optional[float] = None
        self.compile_us = 0.0
        self.readback_us = 0.0
        self.degraded = False
        self.dropped = False
        self.dispatched = False
        self.closed = False

    @property
    def flow_id(self) -> str:
        return self.trace_id

    def breakdown_us(self) -> Dict[str, float]:
        """The six-stage latency split; unreached stages report 0."""
        out = dict.fromkeys(STAGES, 0.0)
        if self.t_drain is not None:
            out["queue_wait"] = max(self.t_drain - self.t_enq, 0.0)
        if self.t_launch is not None and self.t_drain is not None:
            out["coalesce"] = max(self.t_launch - self.t_drain, 0.0)
        out["compile"] = self.compile_us
        if self.t_dispatch is not None and self.t_launch is not None:
            out["launch"] = max(self.t_dispatch - self.t_launch - self.compile_us, 0.0)
        if self.t_device is not None and self.t_dispatch is not None:
            out["device"] = max(self.t_device - self.t_dispatch, 0.0)
        out["readback"] = self.readback_us
        return out

    def end_us(self) -> float:
        for ts in (self.t_device, self.t_dispatch, self.t_launch, self.t_drain):
            if ts is not None:
                return ts
        return self.t_enq


class FlowTracer:
    """Flow table + completion watcher + rollup feeds (see module docstring).

    Args:
        sample_rate: trace 1-in-N minted flows (1 = every flow); sampled-out
            batches cost one counter increment and mint nothing.
        capacity: completed-flow records retained for the exporters (the same
            last-K discipline as the flight ring).

    ``watch_timeout_s`` (``WATCH_TIMEOUT_S``) is the longest the watcher waits for a
    dispatched tick's event before it closes the tick's flows as degraded.
    """

    def __init__(self, sample_rate: int = 1, capacity: int = 1024) -> None:
        if sample_rate < 1:
            raise ValueError(f"sample_rate must be >= 1, got {sample_rate}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample_rate = int(sample_rate)
        self.capacity = int(capacity)
        self.watch_timeout_s = WATCH_TIMEOUT_S
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._open: Dict[str, _Flow] = {}
        self._closed: List[_Flow] = []
        self._pending_readback: Dict[str, List[_Flow]] = {}
        self._since_ckpt: Dict[int, List[str]] = {}
        self._mint_seq = itertools.count()
        self._tick_seq = itertools.count(1)
        self._in_flight = 0  # dispatched work items the watcher has not closed
        #: wall-clock anchor pairing the µs perf_counter timebase with unix
        #: time, so span exports carry absolute nanos
        self.anchor = (time.time(), _flight._now_us())
        self.counts: Dict[str, int] = {
            "minted": 0, "sampled_out": 0, "completed": 0,
            "degraded": 0, "dropped": 0, "device_errors": 0, "watch_timeouts": 0,
        }
        self._work: "_queue_mod.SimpleQueue" = _queue_mod.SimpleQueue()
        self._watcher = threading.Thread(
            target=self._watch, name="tm-flow-watcher", daemon=True
        )
        self._watcher.start()

    # ------------------------------------------------------------- minting

    def mint(self, queue: str, target_id: int, rows: int = 1,
             streams: Tuple[int, ...] = (), sync: bool = False) -> Optional[_Flow]:
        """Mint one flow (or ``None`` when sampled out). Records ``flow_begin``."""
        if (next(self._mint_seq) % self.sample_rate) != 0:
            with self._lock:
                self.counts["sampled_out"] += 1
            return None
        seq = next(_ID_SEQ)
        trace_id = f"{seq:016x}{id(self) & 0xFFFFFFFFFFFFFFFF:016x}"
        fl = _Flow(trace_id, seq, queue, target_id, sync, rows, streams)
        with self._lock:
            self.counts["minted"] += 1
            self._open[trace_id] = fl
        if _flight._RING is not None:
            _flight.record("flow_begin", ts_us=fl.t_enq, flow_id=trace_id,
                           id=seq, queue=queue, rows=rows, sync=sync)
        return fl

    def open_sync(self, queue: str, target_id: int, args: Tuple = (),
                  kwargs: Optional[Dict] = None) -> Optional[_Flow]:
        """Mint + make current for a synchronous ``update()``/``forward()``.

        Returns ``None`` when an ambient flow already covers this call (the
        ingest degrade/eager re-entry) or when sampled out.
        """
        if current() is not None:
            return None
        kwargs = kwargs or {}
        fl = self.mint(
            queue, target_id, rows=_rows_of(args, kwargs),
            streams=host_stream_ids(kwargs.get("stream_ids")), sync=True,
        )
        if fl is not None:
            _push(fl)
        return fl

    def close_sync(self, fl: _Flow) -> None:
        """End an :meth:`open_sync` scope; closes the flow unless the watcher
        now owns it (a successful launch handed it off)."""
        _pop()
        if not fl.dispatched and not fl.closed:
            self._close([fl])

    # -------------------------------------------------------------- stamps

    def stamp_drain(self, flows: Sequence[_Flow]) -> None:
        now = _flight._now_us()
        for fl in flows:
            fl.t_drain = now

    def stamp_launch(self, flows: Sequence[_Flow]) -> None:
        now = _flight._now_us()
        for fl in flows:
            fl.t_launch = now

    def add_compile(self, flows: Sequence[_Flow], dur_us: float) -> None:
        for fl in flows:
            fl.compile_us += float(dur_us)

    def attribute_streams(self, fl: _Flow, streams: Iterable[int]) -> None:
        merged = set(fl.streams)
        merged.update(int(s) for s in streams)
        fl.streams = tuple(sorted(merged))[:64]

    # ------------------------------------------------------------ handoff

    def dispatch(self, flows: Sequence[_Flow], event: Any = None) -> None:
        """Stamp host-dispatch completion and hand the flows to the watcher, which
        stamps device completion when ``event`` (a ``torch.cuda.Event`` recorded
        after the launch's work, outside any capture) completes. ``None`` (a launch
        on the CPU) or an event that completed already closes them inline."""
        if not flows:
            return
        now = _flight._now_us()
        tick = next(self._tick_seq)
        for fl in flows:
            fl.t_dispatch = now
            fl.tick = tick
            fl.dispatched = True
        done = event is None
        if not done:
            try:
                done = event.query()
            except Exception as err:  # noqa: BLE001 — a device fault, not a stamp
                self._fault(tuple(flows), "device_errors", err)
                return
        if done:
            # the launch finished before dispatch returned (the CPU runs eagerly): the
            # device stamp is taken now, so the device stage reads ~0, which is what an
            # already-complete launch means; no handoff to the watcher
            self._close(flows, t_device=_flight._now_us())
            return
        with self._lock:
            self._in_flight += 1
        self._work.put((tuple(flows), event, time.monotonic() + self.watch_timeout_s))

    @thread_role("tm-flow-watcher")
    def _watch(self) -> None:
        """Completion-watcher loop: poll each outstanding tick's event, stamp and close
        its flows when it completes. Never blocks on the device: a ``synchronize()``
        could not be interrupted at shutdown. Ends at the ``None`` sentinel once
        nothing is outstanding."""
        pending: List[Tuple[Tuple[_Flow, ...], Any, float]] = []
        delay = _POLL_MIN_S
        stopping = False
        while True:
            if not pending:
                if stopping:
                    return
                item = self._work.get()
                if item is None:
                    return
                pending.append(item)
                delay = _POLL_MIN_S
            while True:
                try:
                    item = self._work.get_nowait()
                except _queue_mod.Empty:
                    break
                if item is None:
                    stopping = True
                else:
                    pending.append(item)
                    delay = _POLL_MIN_S
            outstanding = []
            for flows, event, deadline in pending:
                try:
                    done = event.query()
                except Exception as err:  # noqa: BLE001 — a device fault, not a stamp
                    self._fault(flows, "device_errors", err, in_flight=True)
                    continue
                if done:
                    self._close(flows, t_device=_flight._now_us(), in_flight=True)
                elif time.monotonic() > deadline:
                    self._fault(flows, "watch_timeouts", TimeoutError(
                        f"tick event incomplete after {self.watch_timeout_s}s"), in_flight=True)
                else:
                    outstanding.append((flows, event, deadline))
            pending = outstanding
            if pending:
                time.sleep(delay)
                delay = min(delay * 2, _POLL_MAX_S)

    def _fault(self, flows: Tuple[_Flow, ...], kind: str, err: BaseException, in_flight: bool = False) -> None:
        """A tick whose completion cannot be observed: count it (``flow/<kind>``),
        record a ``flow_fault`` flight event and close its flows as degraded."""
        _reg.REGISTRY.inc("flow", kind)
        if _flight._RING is not None:
            _flight.record("flow_fault", fault=kind, flows=[fl.trace_id for fl in flows],
                           error=f"{type(err).__name__}: {str(err).splitlines()[0][:200] if str(err) else ''}")
        with self._lock:
            self.counts[kind] += 1
        for fl in flows:
            fl.degraded = True
        self._close(flows, in_flight=in_flight)

    def wait_idle(self, timeout: Optional[float] = 10.0) -> bool:
        """Block until every dispatched flow has been closed by the watcher."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._in_flight > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    # ------------------------------------------------------------- closing

    def close_degraded(self, fl: _Flow) -> None:
        """Close a flow whose tick degraded to the synchronous path."""
        fl.degraded = True
        self._close([fl])

    def close_dropped(self, fl: _Flow) -> None:
        """Close a flow evicted by backpressure (or a drain=False close)."""
        fl.dropped = True
        self._close([fl])

    def close_now(self, flows: Sequence[_Flow]) -> None:
        """Close flows that finished without a chained launch (eager tick)."""
        self._close(flows)

    def _close(self, flows: Sequence[_Flow], t_device: Optional[float] = None, in_flight: bool = False) -> None:
        """Close ``flows`` (idempotent): the tables under the lock, then the rollups
        outside it, so that a producer minting meanwhile waits only for the tables.
        ``in_flight``: the flows were the watcher's, released after their rollups (a
        reader returning from :meth:`wait_idle` sees them in the sketches)."""
        with self._lock:
            closed = []
            for fl in flows:
                if t_device is not None and not fl.closed:
                    fl.t_device = t_device
                if self._close_locked(fl):
                    closed.append(fl)
        for fl in closed:
            self._publish(fl)
        if in_flight:
            with self._lock:
                self._in_flight -= 1
                self._idle.notify_all()

    @locked_by("FlowTracer._lock")
    def _close_locked(self, fl: _Flow) -> bool:
        """Idempotent close of the tables: retention and counts (lock held). True when
        this call closed the flow."""
        if fl.closed:
            return False
        fl.closed = True
        self._open.pop(fl.trace_id, None)
        self._closed.append(fl)
        del self._closed[: -self.capacity]
        if fl.dropped:
            self.counts["dropped"] += 1
        else:
            self.counts["completed"] += 1
            if fl.degraded:
                self.counts["degraded"] += 1
            self._pending_readback.setdefault(fl.queue, []).append(fl)
            del self._pending_readback[fl.queue][: -self.capacity]
            ids = self._since_ckpt.setdefault(fl.target_id, [])
            ids.append(fl.trace_id)
            del ids[: -self.capacity]
        return True

    @staticmethod
    def _publish(fl: _Flow) -> None:
        """A closed flow's rollups: the health sketches and the ``flow_complete`` event."""
        breakdown = fl.breakdown_us()
        total_us = max(fl.end_us() - fl.t_enq, 0.0)
        mon = _health._MONITOR
        if mon is not None and not fl.dropped:
            mon.observe_latency("flow", fl.queue, total_us / 1e6)
            for sid in fl.streams:
                mon.observe_latency("flow", f"{fl.queue}/{sid}", total_us / 1e6)
            for stage in ("queue_wait", "coalesce", "compile", "launch", "device"):
                mon.observe_latency("flow_stage", stage, breakdown[stage] / 1e6)
        if _flight._RING is not None:
            _flight.record(
                "flow_complete",
                flow_id=fl.trace_id, id=fl.seq, queue=fl.queue, tick=fl.tick,
                rows=fl.rows, streams=list(fl.streams),
                degraded=fl.degraded, dropped=fl.dropped,
                t_enq_us=fl.t_enq, t_drain_us=fl.t_drain,
                t_launch_us=fl.t_launch, t_dispatch_us=fl.t_dispatch,
                t_device_us=fl.t_device, total_us=round(total_us, 3),
                **{f"{k}_us": round(v, 3) for k, v in breakdown.items()},
            )

    # ------------------------------------------------------------ readback

    def note_readback(self, queue: str, seconds: float) -> None:
        """Stamp a ``compute()`` host-transfer onto the flows it served —
        every completed-but-unread flow of ``queue`` — and feed the stage
        sketch. Called by ``IngestQueue.compute`` with the tracer active."""
        dur_us = seconds * 1e6
        with self._lock:
            served = self._pending_readback.pop(queue, [])
            for fl in served:
                fl.readback_us = dur_us
        mon = _health._MONITOR
        if mon is not None:
            mon.observe_latency("flow_stage", "readback", seconds)
        if _flight._RING is not None and served:
            _flight.record(
                "flow_readback", queue=queue, flows=len(served),
                readback_us=round(dur_us, 3),
            )

    # ---------------------------------------------------------------- ckpt

    def drain_for_ckpt(self, obj: Any) -> List[str]:
        """Flow IDs completed against ``obj`` since the last checkpoint drain
        — the committed checkpoint's flight dump names the flows it contains."""
        with self._lock:
            return self._since_ckpt.pop(id(obj), [])

    # ------------------------------------------------------------- reading

    def records(self) -> List[_Flow]:
        with self._lock:
            return list(self._closed)

    def open_flows(self) -> List[_Flow]:
        with self._lock:
            return list(self._open.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counts)
            out["open"] = len(self._open)
            out["sample_rate"] = self.sample_rate
        return out

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the watcher once the outstanding ticks completed (or their deadline
        passed); waits at most ``timeout`` seconds for it."""
        self._work.put(None)
        self._watcher.join(timeout=timeout)


# --------------------------------------------------------------- module API


def enable(sample_rate: int = 1, capacity: int = 1024,
           enable_obs: bool = True, device: Any = None) -> FlowTracer:
    """Allocate the tracer and start tracing (idempotent: replaces any previous
    tracer). Flow call sites only run inside obs-gated blocks, so by default this
    turns the obs gate on and, since flow latencies feed the health sketches,
    allocates a health monitor on ``device`` (the card unless the caller names
    another) if none is active."""
    global _TRACER
    prev = _TRACER
    if prev is not None:
        prev.shutdown()
    tracer_ = FlowTracer(sample_rate=sample_rate, capacity=capacity)
    if enable_obs:
        _reg.enable()
        if _health._MONITOR is None:
            try:
                _health.enable(device=device)
            except BaseException:
                tracer_.shutdown()
                raise
    _TRACER = tracer_
    return _TRACER


def disable() -> None:
    """Stop tracing and free the tracer (the zero-overhead default)."""
    global _TRACER
    trc = _TRACER
    _TRACER = None
    if trc is not None:
        trc.shutdown()


def active() -> bool:
    return _TRACER is not None


def tracer() -> Optional[FlowTracer]:
    return _TRACER


def stats() -> Dict[str, int]:
    trc = _TRACER
    return trc.stats() if trc is not None else {}


def records() -> List[_Flow]:
    trc = _TRACER
    return trc.records() if trc is not None else []


def wait_idle(timeout: Optional[float] = 10.0) -> bool:
    trc = _TRACER
    return trc.wait_idle(timeout) if trc is not None else True


def drain_for_ckpt(obj: Any) -> List[str]:
    trc = _TRACER
    return trc.drain_for_ckpt(obj) if trc is not None else []


# ------------------------------------------------------------- span export


def _nanos(trc: FlowTracer, ts_us: float) -> int:
    wall, anchor_us = trc.anchor
    return int((wall + (ts_us - anchor_us) / 1e6) * 1e9)


def _span(trace_id: str, span_id: str, parent: str, name: str,
          start_ns: int, end_ns: int, attrs: Dict[str, Any],
          links: Optional[List[Dict[str, str]]] = None) -> Dict[str, Any]:
    return {
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_span_id": parent,
        "name": name,
        "start_time_unix_nano": start_ns,
        "end_time_unix_nano": max(end_ns, start_ns),
        "attributes": attrs,
        "links": links or [],
    }


def flow_spans(flows: Optional[List[_Flow]] = None) -> List[Dict[str, Any]]:
    """OTLP-shaped spans for the given (default: all retained) closed flows.

    One trace per flow: a root ``flow`` span plus one child span per non-zero
    stage. Each coalesced launch additionally yields one ``tick`` root span
    carrying a span **link** per contained flow — the fan-in edge, modeled as
    links because one launch has many causal parents.
    """
    trc = _TRACER
    if trc is None:
        return []
    if flows is None:
        flows = trc.records()
    spans: List[Dict[str, Any]] = []
    ticks: Dict[Tuple[str, int], List[_Flow]] = {}
    for fl in flows:
        root_id = fl.trace_id[:16]
        breakdown = fl.breakdown_us()
        start = _nanos(trc, fl.t_enq)
        end = _nanos(trc, fl.end_us() + fl.readback_us)
        attrs: Dict[str, Any] = {
            "flow.id": fl.trace_id, "flow.queue": fl.queue,
            "flow.rows": fl.rows, "flow.streams": list(fl.streams),
            "degraded": fl.degraded, "dropped": fl.dropped,
            "flow.sync": fl.sync,
        }
        if fl.tick is not None:
            attrs["flow.tick"] = fl.tick
        attrs.update({f"flow.{k}_us": round(v, 3) for k, v in breakdown.items()})
        spans.append(_span(fl.trace_id, root_id, "", "flow", start, end, attrs))
        cursor = fl.t_enq
        for i, stage in enumerate(STAGES):
            dur = breakdown[stage]
            if dur <= 0.0:
                continue
            child_id = f"{int(root_id, 16) ^ (i + 1):016x}"
            spans.append(_span(
                fl.trace_id, child_id, root_id, f"flow/{stage}",
                _nanos(trc, cursor), _nanos(trc, cursor + dur),
                {"flow.stage": stage, "flow.queue": fl.queue},
            ))
            cursor += dur
        if fl.tick is not None:
            ticks.setdefault((fl.queue, fl.tick), []).append(fl)
    for (queue, tick), members in sorted(ticks.items()):
        digest = hashlib.sha256(f"tick/{queue}/{tick}".encode()).hexdigest()
        t0 = min(m.t_launch or m.t_enq for m in members)
        t1 = max(m.t_device or m.end_us() for m in members)
        spans.append(_span(
            digest[:32], digest[32:48], "", "tick",
            _nanos(trc, t0), _nanos(trc, t1),
            {"flow.queue": queue, "flow.tick": tick, "flow.fan_in": len(members)},
            links=[{"trace_id": m.trace_id, "span_id": m.trace_id[:16]}
                   for m in members],
        ))
    return spans


def export_spans(path: Optional[str] = None,
                 flows: Optional[List[_Flow]] = None) -> List[Dict[str, Any]]:
    """Write the span set as JSONL (one span per line); returns the spans."""
    import json

    spans = flow_spans(flows)
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            for span in spans:
                fh.write(json.dumps(span, sort_keys=True) + "\n")
    return spans


_HEX = frozenset("0123456789abcdef")


def _is_hex(value: Any, width: int) -> bool:
    return (
        isinstance(value, str) and len(value) == width and set(value) <= _HEX
    )


def validate_spans(spans: List[Dict[str, Any]]) -> int:
    """Structurally validate an exported span set; returns the span count.

    The dependency-free analogue of ``prom.validate_exposition`` /
    ``trace.validate_chrome_trace`` for the span path: OTLP-shaped id widths
    (32-hex trace, 16-hex span), unique ``(trace_id, span_id)``, parent and
    link references that resolve *within the set*, and ``start <= end``.
    Raises ``ValueError`` naming the first offending span.
    """
    if not isinstance(spans, list):
        raise ValueError("span export must be a list of span objects")
    seen: set = set()
    for i, sp in enumerate(spans):
        if not isinstance(sp, dict):
            raise ValueError(f"spans[{i}] is not an object")
        if not _is_hex(sp.get("trace_id"), 32):
            raise ValueError(f"spans[{i}] trace_id must be 32 lowercase hex chars")
        if not _is_hex(sp.get("span_id"), 16):
            raise ValueError(f"spans[{i}] span_id must be 16 lowercase hex chars")
        key = (sp["trace_id"], sp["span_id"])
        if key in seen:
            raise ValueError(f"spans[{i}] duplicates span {key}")
        seen.add(key)
        parent = sp.get("parent_span_id")
        if not (parent == "" or _is_hex(parent, 16)):
            raise ValueError(f"spans[{i}] parent_span_id must be '' or 16-hex")
        if not isinstance(sp.get("name"), str) or not sp["name"]:
            raise ValueError(f"spans[{i}] missing non-empty string name")
        start, end = sp.get("start_time_unix_nano"), sp.get("end_time_unix_nano")
        if not isinstance(start, int) or not isinstance(end, int) or end < start:
            raise ValueError(f"spans[{i}] needs integer start <= end nanos")
        if not isinstance(sp.get("attributes"), dict):
            raise ValueError(f"spans[{i}] attributes must be an object")
        if not isinstance(sp.get("links"), list):
            raise ValueError(f"spans[{i}] links must be a list")
    for i, sp in enumerate(spans):
        parent = sp.get("parent_span_id")
        if parent and (sp["trace_id"], parent) not in seen:
            raise ValueError(
                f"spans[{i}] parent {parent!r} does not resolve within the set"
            )
        for j, link in enumerate(sp["links"]):
            if not isinstance(link, dict) or (
                link.get("trace_id"), link.get("span_id")
            ) not in seen:
                raise ValueError(
                    f"spans[{i}] link[{j}] does not resolve within the set"
                )
    return len(spans)
