"""metrics_tpu_torch.serve.server and its command line against the JAX package's
``MetricsServer``, on the CPU (``device="cpu"`` in every config).

- Config errors: the JAX package's malformed cases raise the same error types with
  the same messages (the package's name aside).
- The :class:`AdaptiveTickController`'s interval trajectory on a stepped latency
  trace is bit-equal to the JAX controller's; a deficit round-robin round applies the
  same entries and leaves the same deficits on the same depths.
- Lifecycle, ``/healthz`` over HTTP, fleet ``compute(stream=...)``/``reduce_fleet``,
  the SLO control loop, the drift canary (warn, raise, callable, quiet), both fault
  sites, drain and restart restoring the committed counts with a prewarm that skips
  nothing.
- The values a served collection computes agree with a JAX ``MetricsServer`` fed the
  same batches (MSE and MAE within 1e-6, accuracy exactly) and equal the port's
  synchronous updates bit for bit.
- Two cycles of ``python -m metrics_tpu_torch.serve --device cpu`` in a subprocess,
  SIGTERM between them: ``/healthz`` walks ``503 starting``, ``200 ready``, ``503
  draining``; the second cycle restores what the first committed and its first
  request builds no step.

After every test no server, queue, Prometheus server, flight ring, health monitor,
series sampler or fault schedule is left active.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from metrics_tpu import serve as jserve
from metrics_tpu.serve import server as jserver
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.ckpt import latest_step
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.core import fused as _fused
from metrics_tpu_torch.obs import flight, health, prom, registry, series
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import active_queues, excache
from metrics_tpu_torch.serve.server import (
    AdaptiveTickController,
    CollectionSpec,
    DriftAlert,
    DriftAlertError,
    DriftSpec,
    MetricsServer,
    ServerConfig,
    ServerConfigError,
    ServerStateError,
    active_servers,
    load_config,
)
from tests.torch_deadline import deadline  # noqa: F401
from tests.torch_globals import restores_globals  # noqa: F401

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    excache.disable_recording()
    excache.clear_manifest()
    excache.clear_stats()
    excache.disable_persistent_cache()
    _fused._DEGRADE_WARNED.clear()


@pytest.fixture(autouse=True)
def _leaves_nothing_behind(restores_globals):
    _reset()
    yield
    ckpt.wait_for_all_saves(timeout_s=60)
    jserve.excache.disable_recording()
    jserve.excache.clear_manifest()
    assert {
        "server": active_servers(), "queue": active_queues(), "prom": prom.server_active(),
        "flight": flight.active(), "health": health.active(), "series": series.active(),
        "fault": fault.current(), "gate": registry._ENABLED, "recording": excache.recording(),
    } == {"server": [], "queue": [], "prom": False, "flight": False, "health": False, "series": False,
          "fault": None, "gate": False, "recording": False}
    _reset()


@pytest.fixture
def monitor():
    mon = health.enable(device=CPU, enable_obs=False)
    yield mon
    health.disable()


def _specs(tmp_path=None, names=("a",), fleet=None, metrics=None):
    out = []
    for name in names:
        spec = {"name": name, "metrics": dict(metrics or {"mse": "MeanSquaredError"})}
        if fleet is not None:
            spec["fleet_size"] = fleet
        if tmp_path is not None:
            spec["ckpt_dir"] = str(tmp_path / f"ck_{name}")
        out.append(spec)
    return out


def _config(tmp_path=None, *, names=("a",), fleet=None, metrics=None, **overrides):
    return ServerConfig(_specs(tmp_path, names, fleet, metrics), device=CPU, **overrides)


def _batches(n, rows=32, seed=0, fleet=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        batch = {"args": (rng.random_sample(rows).astype(np.float32), rng.random_sample(rows).astype(np.float32))}
        if fleet is not None:
            batch["stream_ids"] = rng.randint(0, fleet, size=rows).astype(np.int32)
        out.append(batch)
    return out


def _feed(server, name, batches):
    for b in batches:
        server.enqueue(name, *b["args"], stream_ids=b.get("stream_ids"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- config

_MALFORMED = [
    lambda d: d.update(collections=[]),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "NoSuchMetric"}}]),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "MeanSquaredError"}},
                                    {"name": "a", "metrics": {"m": "MeanAbsoluteError"}}]),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "MeanSquaredError"}, "queue": {"nope": 1}}]),
    lambda d: d.update(bogus=True),
    lambda d: d.update(ticker={"bogus": 1}),
    lambda d: d.update(prom={"bogus": 1}),
    lambda d: d.update(excache={"bogus": 1}),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "MeanSquaredError"}, "drift": {"action": "explode"}}]),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "MeanSquaredError"}, "tolerance_bits": 9}]),
    lambda d: d.update(collections=[{"name": "a", "metrics": {"m": "MeanSquaredError"}, "fleet_size": 0}]),
    lambda d: d.update(ticker={"quantum": 0}),
    lambda d: d.update(slo_action="explode"),
    lambda d: d.update(collections="nope"),
]


@pytest.mark.parametrize("case", range(len(_MALFORMED)))
def test_config_rejects_malformed_like_the_jax_package(case):
    errors = []
    for load in (load_config, jserver.load_config):
        d = {"collections": [{"name": "a", "metrics": {"m": "MeanSquaredError"}}]}
        _MALFORMED[case](d)
        with pytest.raises(Exception) as info:
            load(d)
        errors.append(info)
    port, jax_err = errors
    assert port.type.__name__ == jax_err.type.__name__ == "ServerConfigError"
    assert str(port.value).replace("metrics_tpu_torch", "metrics_tpu") == str(jax_err.value)


def test_config_from_json_file_unreadable_and_invalid(tmp_path):
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({
        "name": "eval",
        "collections": [{"name": "quality", "metrics": {"mse": "MeanSquaredError", "mae": "MeanAbsoluteError"},
                         "fleet_size": 4, "slo_p99_ingest_ms": 50.0, "drift": {"max_psi": 0.3, "reference_rows": 128}}],
        "ticker": {"tick_interval_s": 0.01, "quantum": 4, "adaptive": False},
        "prom": {"port": 0, "host": "127.0.0.1"},
        "excache": {"persistent_dir": str(tmp_path / "kernels"), "record": False},
        "device": "cpu",
    }))
    cfg = load_config(str(path))
    assert cfg.name == "eval" and cfg.device == CPU and cfg.quantum == 4 and cfg.adaptive is False
    (spec,) = cfg.collections
    assert all(kw["fleet_size"] == 4 and kw["device"] == CPU for _, kw in spec.metrics.values())
    assert spec.drift.max_psi == 0.3 and load_config(cfg) is cfg
    assert load_config(str(path), device="cuda:3").device == "cuda:3"
    with pytest.raises(ServerConfigError, match="cannot read config"):
        load_config(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ServerConfigError, match="not valid JSON"):
        load_config(str(bad))


def test_collection_spec_injects_fleet_size_device_and_tolerance():
    spec = CollectionSpec("q", {"auroc": "BinaryAUROC", "ap": {"class": "BinaryAveragePrecision"},
                                "curve": {"class": "BinaryAUROC", "kwargs": {"thresholds": 11}},
                                "mse": "MeanSquaredError"},
                          tolerance=1e-3, tolerance_bits=14, device=CPU)
    kw = {label: kwargs for label, (_, kwargs) in spec.metrics.items()}
    assert kw["auroc"] == {"tolerance": 1e-3, "tolerance_bits": 14, "device": CPU} == kw["ap"]
    assert kw["curve"] == {"thresholds": 11, "device": CPU} and kw["mse"] == {"device": CPU}
    target = spec.build()
    assert isinstance(target, MetricCollection) and target["auroc"].tolerance == 1e-3
    jspec = jserver.CollectionSpec("q", {"auroc": "BinaryAUROC", "mse": "MeanSquaredError"}, tolerance=1e-3,
                                   tolerance_bits=14)
    assert {k: {x: y for x, y in v[1].items()} for k, v in jspec.metrics.items()} == {
        "auroc": {"tolerance": 1e-3, "tolerance_bits": 14}, "mse": {}}


# --------------------------------------------------------------- controller


def _stepped_trace():
    return [0.5] * 40 + [20.0] * 12 + [5.0] * 3 + [0.5] * 6 + [None, 8.0, 1.0, 30.0] + [0.1] * 10


def test_adaptive_controller_trajectory_is_bit_equal_to_the_jax_controller():
    ctl = AdaptiveTickController(10.0, interval_s=0.005, min_interval_s=0.0005, max_interval_s=0.25)
    jctl = jserver.AdaptiveTickController(10.0, interval_s=0.005, min_interval_s=0.0005, max_interval_s=0.25)
    depths = [0] * 60 + [3, 0, 2] + [0] * 20
    got = [ctl.observe(p, depth=d) for p, d in zip(_stepped_trace(), depths)]
    want = [jctl.observe(p, depth=d) for p, d in zip(_stepped_trace(), depths)]
    assert got == want and (ctl.grows, ctl.shrinks) == (jctl.grows, jctl.shrinks)
    assert max(got) == 0.25 and min(got) == 0.0005
    for bad in ({"budget_ms": 0.0}, {"budget_ms": 1.0, "min_interval_s": 0.1, "max_interval_s": 0.01},
                {"budget_ms": 1.0, "high_water": 0.2, "low_water": 0.7}):
        with pytest.raises(ValueError):
            AdaptiveTickController(**bad)


@pytest.mark.parametrize("quantum, depths", [(2, (10, 2)), (3, (7, 0, 5)), (64, (12,))])
def test_deficit_round_robin_rounds_equal_the_jax_server(quantum, depths):
    names = tuple(f"c{i}" for i in range(len(depths)))
    trace = []
    for make in (lambda: MetricsServer(_config(names=names, quantum=quantum, adaptive=False), ticker=False),
                 lambda: jserve.MetricsServer(jserver.ServerConfig(_specs(names=names), quantum=quantum,
                                                                   adaptive=False), ticker=False)):
        rounds = []
        with make() as server:
            if quantum == 64:
                server._collections["c0"].queue.max_coalesce = 4
            for i, (name, depth) in enumerate(zip(names, depths)):
                _feed(server, name, _batches(depth, seed=i))
            while any(server._collections[n].queue.depth for n in names):
                applied = server._tick_round()
                rounds.append((applied, dict(server._deficit),
                               tuple(server._collections[n].queue.depth for n in names)))
                assert len(rounds) < 50
            rounds.append(dict(server.stats))
        trace.append(rounds)
    assert trace[0] == trace[1]


# ---------------------------------------------------------------- lifecycle


def test_lifecycle_request_api_and_values_against_the_jax_server():
    batches = _batches(7, seed=3)
    metrics = {"mse": "MeanSquaredError", "mae": "MeanAbsoluteError"}
    ref = MetricCollection({"mse": MeanSquaredError(device=CPU)}, fused=True)
    for b in batches:
        ref.update(*(torch.from_numpy(a) for a in b["args"]))
    server = MetricsServer(_config(metrics=metrics), start=False, ticker=False)
    assert server.state == "starting" and str(server.device) == CPU
    with pytest.raises(ServerStateError, match="requires ready"):
        server.enqueue("a", *batches[0]["args"])
    server.start()
    assert server.state == "ready" and server in active_servers()
    _feed(server, "a", batches)
    served = server.compute("a")
    assert _np(served["mse"]).tobytes() == _np(ref.compute()["mse"]).tobytes()
    with jserve.MetricsServer(jserver.ServerConfig(_specs(metrics=metrics)), ticker=False) as jsrv:
        _feed(jsrv, "a", batches)
        for label, value in jsrv.compute("a").items():
            np.testing.assert_allclose(_np(served[label]), np.asarray(value), atol=1e-6, rtol=0)
    report = server.drain()
    assert server.state == "draining" and report["a"]["update_count"] == len(batches)
    with pytest.raises(ServerStateError):
        server.enqueue("a", *batches[0]["args"])
    assert server.stats["rejected"] == 2
    assert _np(server.compute("a")["mse"]).tobytes() == _np(ref.compute()["mse"]).tobytes()
    assert server.drain() == report
    server.stop()
    assert server.state == "stopped" and server not in active_servers()
    with pytest.raises(ServerStateError):
        server.compute("a")
    with pytest.raises(ServerStateError, match="single-use"):
        server.start()
    with MetricsServer(_config(), ticker=False) as srv:
        with pytest.raises(ServerConfigError, match="unknown collection"):
            srv.enqueue("nope", np.zeros(4, np.float32))
        snap = srv.status()
        assert snap["state"] == "ready" and snap["collections"]["a"]["depth"] == 0 and snap["startup_s"] > 0


def test_fleet_stream_compute_and_reduce_against_the_jax_server():
    fleet = 3
    batches = _batches(6, seed=11, fleet=fleet)
    metrics = {"acc": {"class": "MulticlassAccuracy", "kwargs": {"num_classes": 3, "average": "micro"}}}
    labelled = [{"args": ((b["args"][0] * 3).astype(np.int32) % 3, (b["args"][1] * 3).astype(np.int32) % 3),
                 "stream_ids": b["stream_ids"]} for b in batches]
    with MetricsServer(_config(names=("f",), fleet=fleet, metrics=metrics), ticker=False) as server, \
            jserve.MetricsServer(jserver.ServerConfig(_specs(names=("f",), fleet=fleet, metrics=metrics)),
                                 ticker=False) as jsrv:
        _feed(server, "f", labelled)
        _feed(jsrv, "f", labelled)
        for stream in range(fleet):
            assert _np(server.compute("f", stream=stream)["acc"]) == np.asarray(jsrv.compute("f", stream=stream)["acc"])
        assert _np(server.reduce_fleet("f")["acc"]) == np.asarray(jsrv.reduce_fleet("f")["acc"])
    with MetricsServer(_config(), ticker=False) as server:
        with pytest.raises(ServerStateError, match="no fleet members"):
            server.reduce_fleet("a")


def _probe(host, port):
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_healthz_transitions_over_http_and_server_families():
    seen = {}
    server = MetricsServer(
        _config(prom_port=0), start=False, ticker=False,
        starting_hook=lambda s: seen.setdefault("starting", _probe(*s._prom_address)),
        draining_hook=lambda s: seen.setdefault("draining", _probe(*s._prom_address)),
    )
    server.start()
    try:
        host, port = server._prom_address
        assert seen["starting"] == (503, "starting\n") and _probe(host, port) == (200, "ready\n")
        _feed(server, "a", _batches(3))
        server._tick_round()
        page = prom.render()
        assert prom.validate_exposition(page) > 0
        for family in ("tm_server_state", "tm_server_collections", "tm_server_requests_total",
                       "tm_server_rounds_total", "tm_ingest_queue_depth"):
            assert family in page
        server.drain()
        assert seen["draining"] == (503, "draining\n") and _probe(host, port) == (503, "draining\n")
    finally:
        server.stop()
    assert prom.readiness_probe() == (200, "ok\n") and not prom.server_active()


def test_background_ticker_applies_without_compute():
    with MetricsServer(_config(tick_interval_s=0.002)) as server:
        _feed(server, "a", _batches(5, seed=8))
        deadline = time.monotonic() + 10.0
        while server.stats["applied_entries"] < 5:
            assert time.monotonic() < deadline, "the shared ticker never drained the queue"
            time.sleep(0.01)
        assert server._collections["a"].queue.depth == 0


def test_compute_waits_for_a_tick_in_flight():
    """A tick thread may have drained batches it has not applied yet: a read must wait
    for it (the warm-restart check on the card caught a read that did not)."""
    import threading

    from metrics_tpu_torch.serve import IngestQueue

    applying, release = threading.Event(), threading.Event()
    metric = MeanSquaredError(device=CPU)
    with IngestQueue(metric, start=False) as q:
        orig = q._apply

        def slow_apply(entries):
            applying.set()
            release.wait(10)
            orig(entries)

        q._apply = slow_apply
        q.enqueue(torch.ones(4), torch.zeros(4))
        ticker = threading.Thread(target=q.tick)
        ticker.start()
        assert applying.wait(10) and q.depth == 0  # drained, not applied
        threading.Timer(0.2, release.set).start()
        value = q.compute()
        ticker.join(10)
        assert not ticker.is_alive(), "the tick did not finish within 10 s"
    assert float(value) == 1.0 and metric._update_count == 1


# ----------------------------------------------------------- SLO and drift


def test_control_loop_shrinks_the_interval_under_slo_pressure(monitor):
    cfg = _config(adaptive=True, tick_interval_s=0.05)
    cfg.collections[0].slo_p99_ingest_ms = 1e-6
    server = MetricsServer(cfg, start=False, ticker=False)
    server.controller = AdaptiveTickController(1e-6, interval_s=0.05, min_interval_s=0.0005, max_interval_s=0.25)
    server.start()
    try:
        _feed(server, "a", _batches(4))
        server._collections["a"].queue.flush()
        with pytest.warns(health.SLOViolationWarning, match="SLO violation"):
            server._run_control()
        assert server.tick_interval_s < 0.05 and server.stats["slo_breaches"] >= 1
    finally:
        server.stop()


def test_slo_action_raise_and_callable(monitor):
    cfg = _config(slo_action="raise", adaptive=False)
    cfg.collections[0].slo_p99_ingest_ms = 1e-6
    with MetricsServer(cfg, ticker=False) as server:
        _feed(server, "a", _batches(2))
        server._collections["a"].queue.flush()
        with pytest.raises(health.SLOBudgetExceeded):
            server._run_control()
    seen = []
    cfg = _config(slo_action=seen.append, adaptive=False)
    cfg.collections[0].slo_p99_ingest_ms = 1e-6
    with MetricsServer(cfg, ticker=False) as server:
        _feed(server, "a", _batches(2))
        server._collections["a"].queue.flush()
        server._run_control()
    (violations,) = seen
    assert violations[0]["collection"] == "a" and violations[0]["observed"] > 0


def _drift_config(action, **spec_kw):
    cfg = _config(adaptive=False)
    cfg.collections[0].drift = DriftSpec(reference_rows=64, min_live_rows=64, sample_every=1, action=action, **spec_kw)
    return cfg


def _drive_drift(server):
    rng = np.random.RandomState(0)
    server.enqueue("a", rng.random_sample(64).astype(np.float32), rng.random_sample(64).astype(np.float32))
    server._run_control()  # the reference window; no live rows yet
    shifted = (0.9 + 0.1 * rng.random_sample(64)).astype(np.float32)
    for _ in range(2):
        server.enqueue("a", shifted, rng.random_sample(64).astype(np.float32))
    return server._run_control


def test_drift_canary_warns_like_the_jax_server():
    with MetricsServer(_drift_config("warn"), ticker=False) as server, \
            jserve.MetricsServer(jserver.ServerConfig(_specs()), ticker=False) as jsrv:
        jsrv._collections["a"].drift = jserver._DriftWatch(
            jserver.DriftSpec(reference_rows=64, min_live_rows=64, sample_every=1, action="warn"), "a")
        with pytest.warns(DriftAlert, match="input drift"):
            _drive_drift(server)()
        with pytest.warns(jserver.DriftAlert):
            _drive_drift(jsrv)()
        status = server.status()["collections"]["a"]["drift"]
        jstatus = jsrv.status()["collections"]["a"]["drift"]
        assert status["alerts"] == jstatus["alerts"] == 1 == server.stats["drift_alerts"]
        for key in ("psi", "kl", "tv"):
            assert status[key] == pytest.approx(jstatus[key], rel=1e-5)


def test_drift_canary_raises_and_calls():
    with MetricsServer(_drift_config("raise"), ticker=False) as server:
        run = _drive_drift(server)
        with pytest.raises(DriftAlertError, match="input drift"):
            run()
    alerts = []
    with MetricsServer(_drift_config(alerts.append), ticker=False) as server:
        _drive_drift(server)()
    (alert,) = alerts
    assert alert["collection"] == "a" and alert["psi"] > alert["max_psi"]


def test_drift_canary_quiet_on_stationary_input():
    cfg = _drift_config("raise", num_bins=8)
    cfg.collections[0].drift.reference_rows = 512
    cfg.collections[0].drift.min_live_rows = 512
    with MetricsServer(cfg, ticker=False) as server:
        rng = np.random.RandomState(1)
        for _ in range(4):
            server.enqueue("a", rng.random_sample(512).astype(np.float32), rng.random_sample(512).astype(np.float32))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            server._run_control()
            server._run_control()
        assert server.stats["drift_alerts"] == 0


# -------------------------------------------------------------------- faults


def test_server_request_fault_site():
    batches = _batches(3)
    with MetricsServer(_config(), ticker=False) as server:
        with fault.FaultSchedule(fire_at={"server.request": 0}) as sched:
            with pytest.raises(fault.InjectedFaultError):
                server.enqueue("a", *batches[0]["args"])
            server.enqueue("a", *batches[1]["args"])
        assert sched.fired[0]["collection"] == "a"
        assert server.stats["requests"] == 1 and server._collections["a"].queue.depth == 1


def test_server_drain_fault_salvages_the_queues(tmp_path):
    server = MetricsServer(_config(tmp_path), ticker=False)
    _feed(server, "a", _batches(3))
    try:
        with fault.FaultSchedule(fire_at={"server.drain": 0}):
            with pytest.raises(fault.InjectedFaultError):
                server.drain()
        assert server._collections["a"].queue._closed
        assert int(server._collections["a"].queue.stats["dropped"]) == 3
        assert latest_step(str(tmp_path / "ck_a")) is None
    finally:
        server.stop()


# --------------------------------------------------------------- checkpoints


def test_drain_commits_and_restart_restores_with_prewarm(tmp_path):
    excache.enable_persistent_cache(str(tmp_path / "kernels"))
    batches = _batches(9, seed=21)
    with MetricsServer(_config(tmp_path, names=("a", "b")), ticker=False) as one:
        for name in ("a", "b"):
            _feed(one, name, batches[:1])
            one.compute(name)  # the one-batch tick a first request makes
            _feed(one, name, batches[1:])
        value = _np(one.compute("a")["mse"])
        report = one.drain()
    assert report["a"]["step"] == 0 and report["a"]["update_count"] == 9
    assert (tmp_path / "ck_a" / excache.MANIFEST_NAME).is_file()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with MetricsServer(_config(tmp_path, names=("a", "b")), ticker=False) as two:
            coll = two._collections["a"]
            assert coll.restored_step == 0 and coll.update_count() == 9
            assert excache.last_prewarm()["skipped"] == 0 and excache.last_prewarm()["compiled"] == 2
            misses = coll.queue.step_stats.get("cache_misses", 0)
            _feed(two, "a", batches[:1])
            two.compute("a")
            assert coll.queue.step_stats["cache_misses"] == misses  # the first request builds no step
            assert two._collections["b"].update_count() == 9
    assert value.dtype == np.float32


# -------------------------------------------------- the command line


def _read_until(proc, events, name):
    for line in proc.stdout:
        ev = json.loads(line)
        events[ev["event"]] = ev
        if ev["event"] == name:
            return ev
    raise AssertionError(f"the subprocess exited before emitting {name!r}")


def test_command_line_two_cycles_with_sigterm(tmp_path):
    cfg = {
        "name": "sub",
        "collections": [
            {"name": "a", "metrics": {"mse": "MeanSquaredError"}, "ckpt_dir": str(tmp_path / "ck_a")},
            {"name": "c", "metrics": {"mse": "MeanSquaredError"}, "fleet_size": 2, "ckpt_dir": str(tmp_path / "ck_c")},
        ],
        "prom": {"port": 0},
        "excache": {"persistent_dir": str(tmp_path / "kernels"), "record": True},
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    prev = None
    t0 = time.monotonic()
    for cycle in range(2):
        proc = subprocess.Popen(
            [sys.executable, "-m", "metrics_tpu_torch.serve", "--config", str(cfg_path), "--drive", "--wait-stdin",
             "--device", "cpu", "--rows", "16"],
            stdout=subprocess.PIPE, stdin=subprocess.PIPE, text=True, env=env, cwd=REPO,
        )
        events = {}
        watchdog = threading.Timer(120, proc.kill)  # a hung child fails the test, never the run
        watchdog.start()
        try:
            host, port = _read_until(proc, events, "serving")["prom"]
            assert _probe(host, port) == (503, "starting\n")
            proc.stdin.write("\n")
            proc.stdin.flush()
            ready = _read_until(proc, events, "ready")
            assert ready["device"] == CPU and _probe(host, port) == (200, "ready\n")
            time.sleep(0.5)
            proc.send_signal(signal.SIGTERM)
            _read_until(proc, events, "draining")
            assert _probe(host, port) == (503, "draining\n")
            proc.stdin.write("\n")
            proc.stdin.flush()
            stopped = _read_until(proc, events, "stopped")
            assert proc.wait(timeout=60) == 0
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        assert all(stopped["launches_eq_ticks"].values()), stopped["launches_eq_ticks"]
        committed = {k: v["update_count"] for k, v in stopped["committed"].items()}
        assert all(count > 1 for count in committed.values())
        if cycle == 0:
            assert ready["restored"] == {"a": None, "c": None}
        else:
            assert ready["restored_update_counts"] == prev
            assert ready["first_request_compiles"] == 0 and ready["prewarm"]["skipped"] == 0
        prev = committed
    assert time.monotonic() - t0 < 60
