"""``python -m metrics_tpu_torch.serve``: run a :class:`MetricsServer` from a JSON
config (counterpart of ``metrics_tpu/serve/__main__.py``).

The process speaks a line protocol on stdout, one JSON object a line:

``{"event": "serving", "prom": [host, port], ...}``
    ``/healthz`` is up (``503 starting``); restore and prewarm are about to run.
``{"event": "ready", "restored": {...}, "first_request_compiles": 0, ...}``
    Startup is done: each collection's restored step and update count, the prewarm
    report and, with ``--probe``, the builds (kernel builds and step captures, while
    the config's persistent kernel directory is set) that one deterministic first
    request a collection cost: 0 after a restart with a warm manifest.
``{"event": "draining", ...}`` / ``{"event": "stopped", ...}``
    Shutdown: the last line carries what was committed (update counts, checkpoint
    steps), the queues' statistics, whether every tick was one chained replay
    (``launches_eq_ticks``), the results and the throughput.

SIGTERM and SIGINT ask for a graceful drain: the handler only sets an event and the
main thread drains, checkpoints (with the warm manifest) and stops, then exits 0.
``--wait-stdin`` holds the ``starting -> ready`` and ``draining -> stopped``
transitions until a line arrives on stdin, so that a parent can watch each
``/healthz`` phase. ``--drive`` sends seeded synthetic traffic of a fixed shape.
``--device`` replaces the config's device (``cuda`` unless the config names another).
"""
import argparse
import json
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.serve import excache as _excache
from metrics_tpu_torch.serve.server import MetricsServer, load_config

#: the graceful-shutdown request; the signal handler only sets it
_STOPPING = threading.Event()


def _on_signal(signum: int, frame: Any) -> None:
    _STOPPING.set()


def _emit(event: str, **kv: Any) -> None:
    print(json.dumps({"event": event, **kv}, sort_keys=True, default=str), flush=True)


def _batch(rng: np.random.RandomState, rows: int, fleet_size: Optional[int]) -> Dict[str, Any]:
    """One synthetic batch: a (preds, target) pair in [0, 1] of a constant shape
    (stream ids with a fleet), drawn as the JAX package's ``_batch`` draws it."""
    preds = rng.random_sample(rows).astype(np.float32)
    target = rng.random_sample(rows).astype(np.float32)
    out: Dict[str, Any] = {"args": (preds, target)}
    if fleet_size is not None:
        out["stream_ids"] = rng.randint(0, fleet_size, size=rows).astype(np.int32)
    return out


def _jsonable(value: Any) -> Any:
    if hasattr(value, "tolist"):
        return value.tolist()
    return value


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.serve", description="Run a MetricsServer from a declarative JSON config."
    )
    parser.add_argument("--config", required=True, help="path to the JSON server config")
    parser.add_argument("--drive", action="store_true", help="send deterministic synthetic traffic")
    parser.add_argument("--duration", type=float, default=0.0, help="drive for this many seconds (0: until SIGTERM)")
    parser.add_argument("--rows", type=int, default=64, help="rows a synthetic batch")
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic traffic")
    parser.add_argument("--probe", dest="probe", action="store_true", default=True,
                        help="send one deterministic first request a collection after ready (default)")
    parser.add_argument("--no-probe", dest="probe", action="store_false")
    parser.add_argument("--wait-stdin", action="store_true",
                        help="hold starting->ready and draining->stopped until a stdin line each")
    parser.add_argument("--device", default=None, help="the device to serve on (replaces the config's)")
    args = parser.parse_args(argv)

    config = load_config(args.config, device=args.device)
    _obs.enable()
    from metrics_tpu_torch.obs import health as _health_mod

    _health_mod.enable(device=config.device)
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    def _gate() -> None:
        if args.wait_stdin:
            sys.stdin.readline()

    def _on_starting(server: MetricsServer) -> None:
        _emit("serving", server=server.name, prom=server._prom_address, collections=list(server._order))
        _gate()

    def _on_draining(server: MetricsServer) -> None:
        _emit("draining", server=server.name)
        _gate()

    server = MetricsServer(config, start=False, starting_hook=_on_starting, draining_hook=_on_draining)
    enqueued: Dict[str, int] = {}
    t_start = time.monotonic()
    try:
        server.start()
        restored = {n: server._collections[n].restored_step for n in server._order}
        restored_counts = {n: server._collections[n].update_count() for n in server._order}
        first_request_compiles = None
        if args.probe:
            before = _excache.stats().get("compiles", 0)
            rng = np.random.RandomState(args.seed)
            for name in server._order:
                spec = server._collections[name].spec
                batch = _batch(rng, args.rows, spec.fleet_size)
                server.enqueue(name, *batch["args"], stream_ids=batch.get("stream_ids"))
                server.compute(name)
            first_request_compiles = _excache.stats().get("compiles", 0) - before
        _emit(
            "ready",
            server=server.name,
            restored=restored,
            restored_update_counts=restored_counts,
            first_request_compiles=first_request_compiles,
            prewarm=_excache.last_prewarm(),
            startup_s=server.startup_s,
            device=str(server.device),
        )
        if args.drive:
            rng = np.random.RandomState(args.seed + 1)
            deadline = t_start + args.duration if args.duration > 0 else None
            while not _STOPPING.is_set():
                if deadline is not None and time.monotonic() >= deadline:
                    break
                for name in server._order:
                    spec = server._collections[name].spec
                    batch = _batch(rng, args.rows, spec.fleet_size)
                    server.enqueue(name, *batch["args"], stream_ids=batch.get("stream_ids"))
                    enqueued[name] = enqueued.get(name, 0) + 1
        else:
            while not _STOPPING.is_set():
                _STOPPING.wait(0.1)
        elapsed = time.monotonic() - t_start
        report = server.drain()
        queue_stats = {n: dict(server._collections[n].queue.stats) for n in server._order}
        results = {n: {k: _jsonable(v) for k, v in server.compute(n).items()} for n in server._order}
        snapshot = _obs.snapshot()
        total = sum(enqueued.values())
        _emit(
            "stopped",
            server=server.name,
            committed=report,
            enqueued=enqueued,
            enqueues_per_s=round(total / elapsed, 2) if elapsed > 0 else None,
            queue_stats=queue_stats,
            launches_eq_ticks={n: queue_stats[n]["launches"] == queue_stats[n]["ticks"] for n in server._order},
            dispatches=snapshot.get("ingest", {}).get("launches", 0),
            excache=_excache.stats(),
            results=results,
            elapsed_s=round(elapsed, 3),
        )
        return 0
    finally:
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
