"""Cross-host obs aggregation: one fleet-wide snapshot from per-host telemetry
(counterpart of ``metrics_tpu/obs/aggregate.py``).

A serving job of many processes runs one obs registry and health monitor a process;
"what is the fleet's p99 update latency" needs them merged. This module merges them
with the algebra the metric states themselves use:

- **counters sum**: events on host A plus events on host B are fleet events;
- **timers** sum ``count``/``total_s`` and take the **max** of ``max_s``;
- **device-memory watermarks max**: the fleet watermark is the fullest device;
- **latency QuantileSketch states merge exactly**: every sketch leaf is a
  sum-reduced int32 histogram, so the merge is elementwise integer addition,
  bit-identical to bucketing every host's observations into one sketch, and the
  merged quantiles keep the relative-error certificate. The port's sketches live on
  the card; :func:`host_snapshot` moves them to the host once.

The unit of exchange is :func:`host_snapshot`, a JSON-serializable dict stamped with
this process's ``(rank, world)`` from
:func:`metrics_tpu_torch.parallel.collective.process_topology`. The layout is the JAX
package's, so that snapshots of both packages merge into one aggregate. Transport is
the caller's: :func:`aggregate` merges a list, and :func:`publish` with
:func:`aggregate_dir` is the shared-directory exchange (each host writes
``obs-h<rank>.json`` atomically; any host merges the directory). Every wait on
another host's file has a deadline (``timeout_s``). The ``agg.publish`` and
``agg.read`` fault sites sit at the write and at each file's read.

Nothing here runs on an instrumented hot path: aggregation *pulls* registry and
health state when called, and works (degenerately) with the obs gate off.
"""
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _reg

SCHEMA_VERSION = 1


def host_snapshot() -> Dict[str, Any]:
    """This process's obs state as one JSON-serializable, mergeable dict."""
    from metrics_tpu_torch.parallel.collective import process_topology

    rank, world = process_topology()
    monitor = _health._MONITOR
    return {
        "schema": SCHEMA_VERSION,
        "host": rank,
        "world": world,
        "counters": _reg.snapshot(),
        "hbm_watermark_bytes": (
            monitor.hbm_watermark_bytes if monitor is not None else None
        ),
        "latency_sketches": monitor.export_sketches() if monitor is not None else {},
    }


def _merge_counters(
    into: Dict[str, Dict[str, Any]], snap: Dict[str, Dict[str, Any]]
) -> None:
    for scope, names in snap.items():
        dst = into.setdefault(scope, {})
        for name, value in names.items():
            if isinstance(value, dict):
                cur = dst.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                cur["count"] += value.get("count", 0)
                cur["total_s"] += value.get("total_s", 0.0)
                cur["max_s"] = max(cur["max_s"], value.get("max_s", 0.0))
            else:
                dst[name] = dst.get(name, 0) + value


def _add_leaves(a: Any, b: Any) -> Any:
    """Elementwise integer addition over tolist()-shaped sketch leaves."""
    if isinstance(a, list):
        if len(a) != len(b):
            raise ValueError(
                f"sketch state leaves have mismatched lengths ({len(a)} vs {len(b)})"
            )
        return [_add_leaves(x, y) for x, y in zip(a, b)]
    return a + b


def _merge_sketches(
    into: Dict[str, Dict[str, Any]], sketches: Dict[str, Dict[str, Any]]
) -> None:
    for key, entry in sketches.items():
        cur = into.get(key)
        if cur is None:
            into[key] = {
                "params": dict(entry["params"]),
                "state": {k: json.loads(json.dumps(v)) for k, v in entry["state"].items()},
                "count": int(entry["count"]),
            }
            continue
        if cur["params"] != entry["params"]:
            raise ValueError(
                f"cannot merge latency sketch {key!r}: hosts disagree on sketch"
                f" params ({cur['params']} vs {entry['params']}) — merged quantiles"
                " would silently lose their certificate"
            )
        if set(cur["state"]) != set(entry["state"]):
            raise ValueError(
                f"cannot merge latency sketch {key!r}: state leaves differ"
                f" ({sorted(cur['state'])} vs {sorted(entry['state'])})"
            )
        cur["state"] = {
            k: _add_leaves(cur["state"][k], entry["state"][k]) for k in cur["state"]
        }
        cur["count"] += int(entry["count"])


def _quantiles_of(entry: Dict[str, Any]) -> Dict[str, Any]:
    """Compute the percentile row for one merged sketch entry."""
    import torch

    from metrics_tpu_torch.sketches import QuantileSketch

    sk = QuantileSketch(**entry["params"], device="cpu")
    state = {k: torch.tensor(v, dtype=torch.int32) for k, v in entry["state"].items()}
    out = sk.compute_from(state)
    row: Dict[str, Any] = {"count": int(entry["count"])}
    for q, v, c in zip(
        sk.quantiles, out["quantiles"].tolist(), out["certified"].tolist()
    ):
        row[f"p{round(q * 100):d}_us"] = round(float(v), 3)
        row[f"p{round(q * 100):d}_certified"] = bool(c)
    return row


def aggregate(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-host snapshots into one fleet-wide view with host breakdown.

    Returns ``{"hosts": <count>, "world": ..., "counters": <summed registry
    shape>, "hbm_watermark_bytes": <fleet max>, "latency_us": {key:
    percentile row computed from the merged sketch state},
    "latency_sketches": <merged, still-mergeable states>, "per_host": [...]}``
    — the merged output is itself a valid input to a higher aggregation level
    (rack → pod → fleet composes, because every reduction is associative).

    Coverage annotation: the output carries ``world_observed`` (how many
    original host snapshots this aggregate covers — inputs default to 1, an
    aggregate contributes its own count, so the field **sums**) and
    ``world_expected`` (the largest expected world any input claimed, so the
    field takes the **max**). Both reductions are associative, which is what
    lets a partial merge from :func:`aggregate_dir` keep composing up the
    rack → pod → fleet tree without losing track of who was missing.
    """
    if not snapshots:
        raise ValueError("aggregate() needs at least one host snapshot")
    counters: Dict[str, Dict[str, Any]] = {}
    sketches: Dict[str, Dict[str, Any]] = {}
    hbm: Optional[int] = None
    per_host: List[Dict[str, Any]] = []
    world = 0
    world_observed = 0
    world_expected = 0
    for snap in snapshots:
        if snap.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"host snapshot schema {snap.get('schema')!r} != {SCHEMA_VERSION}"
            )
        _merge_counters(counters, snap.get("counters", {}))
        _merge_sketches(sketches, snap.get("latency_sketches", {}))
        host_hbm = snap.get("hbm_watermark_bytes")
        if host_hbm is not None:
            hbm = host_hbm if hbm is None else max(hbm, host_hbm)
        world = max(world, snap.get("world", 0))
        world_observed += int(snap.get("world_observed", 1))
        world_expected = max(
            world_expected, int(snap.get("world_expected", snap.get("world", 0) or 1))
        )
        per_host.append(
            {
                "host": snap.get("host"),
                "hbm_watermark_bytes": host_hbm,
                "events_total": sum(
                    value
                    for names in snap.get("counters", {}).values()
                    for value in names.values()
                    if not isinstance(value, dict)
                ),
                "latency_keys": sorted(snap.get("latency_sketches", {})),
            }
        )
    per_host.sort(key=lambda h: (h["host"] is None, h["host"]))
    return {
        "schema": SCHEMA_VERSION,
        "hosts": len(snapshots),
        "world": world,
        "world_observed": world_observed,
        "world_expected": world_expected,
        "counters": counters,
        "hbm_watermark_bytes": hbm,
        "latency_us": {key: _quantiles_of(entry) for key, entry in sketches.items()},
        "latency_sketches": sketches,
        "per_host": per_host,
    }


# ------------------------------------------------- shared-directory exchange


def _host_path(dirpath: str, rank: int) -> str:
    return os.path.join(dirpath, f"obs-h{rank:04d}.json")


def publish(dirpath: str, snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Write this host's snapshot to ``dirpath/obs-h<rank>.json``, atomically.

    Every process publishes into one shared directory (a temporary file, fsync,
    then rename, so that readers never see a torn file), then any process calls
    :func:`aggregate_dir`. Returns the path written.
    """
    snap = host_snapshot() if snapshot is None else snapshot
    path = _host_path(dirpath, int(snap["host"]))
    if _fault._SCHEDULE is not None:
        _fault.fire("agg.publish", host=snap.get("host"))
    os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirpath, prefix=".obs-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(snap, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def aggregate_dir(
    dirpath: str,
    expect_world: Optional[int] = None,
    *,
    timeout_s: Optional[float] = None,
    min_world: Optional[int] = None,
    poll_interval_s: float = 0.05,
) -> Dict[str, Any]:
    """Merge every ``obs-h*.json`` under ``dirpath`` (see :func:`aggregate`).

    Two modes:

    - **Strict** (default, neither ``timeout_s`` nor ``min_world`` given):
      ``expect_world`` makes a partial exchange loud — fewer published hosts
      than the expected world raises instead of silently reporting a partial
      fleet, and an unreadable/torn snapshot file propagates its error.
    - **Tolerant** (``timeout_s`` and/or ``min_world`` given): wait up to
      ``timeout_s`` seconds (polling every ``poll_interval_s``) for
      ``expect_world`` hosts to publish, then merge whatever arrived —
      skipping unreadable files — and return a **coverage-annotated partial
      aggregate**: ``world_observed`` says how many hosts actually landed,
      ``world_expected`` what the fleet should have been (both still compose
      associatively through further :func:`aggregate` levels). ``min_world``
      is the floor under the partial answer: fewer readable snapshots than
      that raises, because an "aggregate" covering almost nobody is worse
      than an error.
    """
    tolerant = timeout_s is not None or min_world is not None
    target = expect_world if expect_world is not None else min_world

    def read_all() -> tuple:
        snapshots: List[Dict[str, Any]] = []
        skipped = 0
        for entry in sorted(os.listdir(dirpath)):
            if not (entry.startswith("obs-h") and entry.endswith(".json")):
                continue
            try:
                if _fault._SCHEDULE is not None:
                    _fault.fire("agg.read", file=entry)
                with open(os.path.join(dirpath, entry)) as f:
                    snapshots.append(json.load(f))
            except (OSError, ValueError):
                if not tolerant:
                    raise
                skipped += 1
        return snapshots, skipped

    snapshots, skipped = read_all()
    if timeout_s is not None and target is not None and len(snapshots) < target:
        from metrics_tpu_torch.parallel.collective import wait_for_world

        latest = {"snaps": snapshots, "skipped": skipped}

        def observed() -> int:
            latest["snaps"], latest["skipped"] = read_all()
            return len(latest["snaps"])

        wait_for_world(
            observed, target, timeout_s=timeout_s, poll_interval_s=poll_interval_s
        )
        snapshots, skipped = latest["snaps"], latest["skipped"]
    if min_world is not None and len(snapshots) < min_world:
        raise ValueError(
            f"aggregate_dir: only {len(snapshots)} readable host snapshots under"
            f" {dirpath!r} after waiting, below min_world={min_world}"
            f" ({skipped} unreadable)"
        )
    if not tolerant and expect_world is not None and len(snapshots) < expect_world:
        raise ValueError(
            f"aggregate_dir: found {len(snapshots)} host snapshots under"
            f" {dirpath!r}, expected {expect_world}"
        )
    out = aggregate(snapshots)
    if expect_world is not None:
        out["world_expected"] = max(out["world_expected"], int(expect_world))
    return out


def fleet_snapshot() -> Dict[str, Any]:
    """This process's view of the fleet — in a single-process runtime, the
    aggregate of its own snapshot (the world==1 degenerate case)."""
    return aggregate([host_snapshot()])
