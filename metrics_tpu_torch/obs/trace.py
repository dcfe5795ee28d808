"""Chrome ``trace_event`` export of the ``tm.*`` runtime timeline (counterpart of
``metrics_tpu/obs/trace.py``).

Turns the flight-recorder window (``obs/flight.py``) into a JSON object-format trace,
``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": ...}``, loadable in
``chrome://tracing`` and https://ui.perfetto.dev, and set beside a ``torch.profiler``
trace of the same run (``obs.trace(path)``): the host slices here carry the same
``tm.update/<Metric>`` / ``tm.fused/step`` names as the ``record_function`` ranges there.

Track model, one track per metric or engine:

- every ``scope`` flight event (a timed ``tm.*`` window from ``obs/scopes.py``)
  becomes a complete slice (``"ph": "X"``) on the track of the metric or engine that
  owns it (``tm.update/BinaryAccuracy`` → track ``BinaryAccuracy``, ``tm.fused/step``
  → track ``fused``);
- point events (``dispatch``, ``retrace``, ``fused_cache_miss``, ``fleet_route``,
  ``merge``, ``ckpt_*``) become instants (``"ph": "i"``) on the owning track, their
  fields (input shapes, cache keys, routed rows, commit steps) in ``args``;
- tracks are named by ``thread_name`` metadata events. Events that carry a
  ``queue``/``engine`` instance field get the instance suffixed onto the track
  (``ingest_tick/replica-a``), so that two queues of one metric class never share a
  row;
- ``flow_complete`` events (``obs/flow.py``) are rendered as **flow arrows**: per flow
  an enqueue slice on ``ingest/<queue>``, ONE launch slice per coalesced tick on
  ``launcher/<queue>``, a device slice on ``compute/<queue>``, and ``ph s/t/f`` flow
  events (keyed by the flow's integer id) linking them.

Naming note: the *module* ``metrics_tpu_torch.obs.trace`` (this file) is the exporter;
the *attribute* ``metrics_tpu_torch.obs.trace`` is the ``torch.profiler`` capture of
``obs/scopes.py``, as in the JAX package. Use ``obs.export_chrome_trace(...)`` and
``obs.chrome_trace_events()`` (re-exported at the package root).
"""
import json
import os
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.obs import flight as _flight
from metrics_tpu_torch.obs import registry as _reg

#: event kinds rendered as instants, with the track they land on. ``None``
#: means "take the track from the event's ``metric`` field".
_INSTANT_TRACKS = {
    "dispatch": None,
    "retrace": None,
    "merge": None,
    "fused_launch": "fused",
    "fused_cache_miss": "fused",
    "fleet_route": None,
    "ckpt_save_begin": "ckpt",
    "ckpt_save_commit": "ckpt",
    "ckpt_restore": "ckpt",
}


def _scope_track(label: str) -> str:
    """``tm.update/BinaryAccuracy`` -> ``BinaryAccuracy``; ``tm.fused/step`` ->
    ``fused``; ``tm.collection.update`` -> ``collection``."""
    if label.startswith("tm."):
        label = label[3:]
    if "/" in label:
        op, owner = label.split("/", 1)
        return "fused" if op == "fused" else owner
    return label.split(".", 1)[0]


def chrome_trace_events(events: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """Flight events -> ``trace_event`` dicts (µs timestamps, one tid/track)."""
    if events is None:
        events = _flight.events()
    pid = os.getpid()
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": "metrics_tpu_torch"},
        }
    ]

    def tid_for(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        return tid

    #: coalesced ticks already given their single launch/device slice
    flow_ticks: set = set()

    for ev in events:
        kind = ev.get("kind")
        args = {
            k: v for k, v in ev.items() if k not in ("kind", "ts_us", "seq", "dur_us")
        }
        args["seq"] = ev.get("seq")
        if kind == "flow_complete":
            out.extend(_flow_events(ev, pid, tid_for, flow_ticks))
            continue
        if kind == "scope":
            label = ev.get("name", "tm.scope")
            out.append(
                {
                    "ph": "X",
                    "name": label,
                    "cat": "tm",
                    "ts": ev["ts_us"],
                    "dur": max(float(ev.get("dur_us", 0.0)), 0.001),
                    "pid": pid,
                    "tid": tid_for(_scope_track(label)),
                    "args": args,
                }
            )
            continue
        track = _INSTANT_TRACKS.get(kind)
        if track is None:
            track = str(ev.get("metric", kind))
        # two queues (or engines) sharing a metric class must not share a
        # track: suffix with the instance name whenever the event carries one
        instance = ev.get("queue") or ev.get("engine")
        if instance is not None:
            track = f"{track}/{instance}"
        out.append(
            {
                "ph": "i",
                "name": str(kind),
                "cat": "tm",
                "s": "t",  # thread-scoped instant
                "ts": ev["ts_us"],
                "pid": pid,
                "tid": tid_for(track),
                "args": args,
            }
        )
    return out


def _flow_events(
    ev: Dict[str, Any], pid: int, tid_for: Any, ticks_done: set
) -> List[Dict[str, Any]]:
    """One ``flow_complete`` flight event -> slices + flow-arrow events.

    Per flow: an enqueue slice on ``ingest/<queue>`` holding the arrow start
    (``ph s``); per coalesced tick (shared by every flow the launch served):
    ONE launch slice on ``launcher/<queue>`` and one device slice on
    ``compute/<queue>``; per flow again: a ``ph t`` step bound to the launch
    slice and a ``ph f`` finish bound to the device slice. Flows that never
    launched (degraded/dropped before dispatch) render their enqueue slice
    only — an arrow needs both ends.
    """
    queue = str(ev.get("queue", "?"))
    fid = ev.get("id")
    t_enq = ev.get("t_enq_us")
    if t_enq is None:
        return []
    out: List[Dict[str, Any]] = []
    enq_tid = tid_for(f"ingest/{queue}")
    args = {
        "flow_id": ev.get("flow_id"),
        "rows": ev.get("rows"),
        "streams": ev.get("streams"),
        "degraded": ev.get("degraded"),
        "dropped": ev.get("dropped"),
        "seq": ev.get("seq"),
        **{k: ev.get(k) for k in ("queue_wait_us", "coalesce_us", "compile_us",
                                  "launch_us", "device_us", "readback_us")},
    }
    queue_wait = float(ev.get("queue_wait_us") or 0.0)
    out.append(
        {
            "ph": "X", "name": "flow/enqueue", "cat": "flow",
            "ts": t_enq, "dur": max(queue_wait, 0.001),
            "pid": pid, "tid": enq_tid, "args": args,
        }
    )
    t_launch = ev.get("t_launch_us")
    t_dispatch = ev.get("t_dispatch_us")
    t_device = ev.get("t_device_us")
    tick = ev.get("tick")
    if fid is None or t_launch is None or t_dispatch is None or t_device is None:
        return out
    launch_tid = tid_for(f"launcher/{queue}")
    device_tid = tid_for(f"compute/{queue}")
    tick_key = (queue, tick)
    if tick_key not in ticks_done:
        ticks_done.add(tick_key)
        out.append(
            {
                "ph": "X", "name": "flow/launch", "cat": "flow",
                "ts": t_launch, "dur": max(t_dispatch - t_launch, 0.001),
                "pid": pid, "tid": launch_tid,
                "args": {"tick": tick, "queue": queue},
            }
        )
        out.append(
            {
                "ph": "X", "name": "flow/device", "cat": "flow",
                "ts": t_dispatch, "dur": max(t_device - t_dispatch, 0.001),
                "pid": pid, "tid": device_tid,
                "args": {"tick": tick, "queue": queue},
            }
        )
    arrow = {"name": "flow", "cat": "flow", "id": fid, "pid": pid}
    out.append({"ph": "s", "ts": t_enq, "tid": enq_tid, **arrow})
    out.append({"ph": "t", "ts": t_launch, "tid": launch_tid, **arrow})
    out.append({"ph": "f", "bp": "e", "ts": t_device, "tid": device_tid, **arrow})
    return out


def export_chrome_trace(
    path: str,
    events: Optional[List[Dict[str, Any]]] = None,
    include_registry: bool = True,
) -> Dict[str, Any]:
    """Write the trace JSON to ``path``; returns the written object.

    ``otherData`` carries the registry counter snapshot (when obs holds one)
    so a single file answers both "what happened when" and "how often".
    """
    trace_events = chrome_trace_events(events)
    obj: Dict[str, Any] = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "metrics_tpu_torch.obs.trace"},
    }
    if include_registry:
        obj["otherData"]["registry"] = _reg.snapshot()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, default=str)
    return obj


def validate_chrome_trace(obj: Dict[str, Any]) -> int:
    """Structural check against the ``trace_event`` format; returns the event
    count. Raises ``ValueError`` naming the first offending event, so that a test
    can hold an exported file to the format without a UI.
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a `traceEvents` list")
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "M", "B", "E", "C", "s", "t", "f"):
            raise ValueError(f"traceEvents[{i}] has unsupported ph={ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}] missing string `name`")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            raise ValueError(f"traceEvents[{i}] missing integer pid/tid")
        if ph in ("X", "i", "I", "B", "E", "C", "s", "t", "f") and not isinstance(
            ev.get("ts"), (int, float)
        ):
            raise ValueError(f"traceEvents[{i}] ({ph}) missing numeric `ts`")
        if ph in ("s", "t", "f") and not isinstance(ev.get("id"), (int, str)):
            raise ValueError(
                f"traceEvents[{i}] ({ph}) flow event missing its `id` binding"
            )
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}] (X) missing numeric `dur`")
        if ph == "M" and "args" not in ev:
            raise ValueError(f"traceEvents[{i}] (M) missing `args`")
    return len(obj["traceEvents"])
