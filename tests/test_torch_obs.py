"""metrics_tpu_torch.obs (flight recorder, state reports, health, series, Prometheus
export) against the JAX package's, on the CPU.

- The flight ring's window, the dump's schema, the try-lock state reports and the
  chained failure handlers (SIGTERM between an update and a checkpoint commit, in a
  subprocess), and the ``ckpt_integration`` dump that rides the committed step.
- ``state_report``/``summary`` rows equal the JAX package's for the same metrics and
  inputs, but for the listed int64 counts and the ``None`` layout columns.
- The health monitor fed the JAX monitor's latencies lands them in the same
  QuantileSketch slots (equal counters; quantiles within 1e-6), and the SLO verdicts
  on equal registry contents are equal.
- ``prom.render`` gives the JAX package's sample names and values for equal registry,
  health and server contents; ``validate_exposition`` accepts and rejects the JAX
  tests' pages; the port's families ignore live JAX queues and servers.

After every test no server, queue, Prometheus server, flight ring, health monitor,
series sampler or fault schedule is left active.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.obs as jobs
from metrics_tpu import serve as jserve
from metrics_tpu.classification import BinaryAUROC as JBinaryAUROC
from metrics_tpu.classification import MulticlassAccuracy as JMulticlassAccuracy
from metrics_tpu.core.collections import MetricCollection as JMetricCollection
from metrics_tpu.regression import MeanSquaredError as JMeanSquaredError
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.obs import flight, health, prom, registry, series
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import active_queues, excache
from metrics_tpu_torch.serve import server as tserver
from metrics_tpu_torch.utils.prints import render_collection_summary, render_state_report

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_jax_obs():
    jserve.excache.disable_recording()
    jserve.excache.clear_manifest()
    jobs.flight.disable()
    jobs.health.disable()
    jobs.series.disable()
    jobs.prom.clear_readiness()
    jobs.prom.stop_server()
    jobs.disable()
    jobs.REGISTRY.clear()


def _leaks():
    return {
        "server": tserver.active_servers(),
        "queue": active_queues(),
        "prom": prom.server_active(),
        "flight": flight.active(),
        "health": health.active(),
        "series": series.active(),
        "fault": fault.current(),
        "gate": registry._ENABLED,
        "recording": excache.recording(),
    }


_NONE_LEFT = {"server": [], "queue": [], "prom": False, "flight": False, "health": False, "series": False,
              "fault": None, "gate": False, "recording": False}


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    _reset_jax_obs()
    registry.REGISTRY.clear()
    yield
    ckpt.wait_for_all_saves(timeout_s=60)
    _reset_jax_obs()
    assert _leaks() == _NONE_LEFT
    registry.REGISTRY.clear()


@pytest.fixture
def surfaces():
    """For a test that turns surfaces on itself: turned off again after it."""
    yield
    flight.disable()
    health.disable()
    series.disable()
    prom.clear_readiness()
    prom.stop_server()
    registry.disable()


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


# ------------------------------------------------------------ flight recorder


def test_flight_window_is_bounded_and_ordered(surfaces):
    flight.enable(capacity=4)
    assert registry._ENABLED
    for i in range(10):
        flight.record("probe", i=i)
    evs = flight.events()
    assert [e["i"] for e in evs] == [6, 7, 8, 9]
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    assert flight.last(2)[-1]["i"] == 9 and flight.capacity() == 4
    flight.clear()
    assert flight.events() == []
    with pytest.raises(ValueError):
        flight.enable(capacity=0)


def test_flight_records_dispatch_merge_and_quarantine_like_the_jax_package(surfaces):
    x = np.ones(3, np.float32)
    flight.enable(capacity=64)
    m, other = MeanSquaredError(device=CPU), MeanSquaredError(device=CPU)
    m.update(*_t(x, x))
    other.update(*_t(x, x))
    m.merge_state(other)
    poisoned = MeanSquaredError(device=CPU, nan_policy="count")
    poisoned.update(*_t(np.array([np.nan, 1.0, 2.0], np.float32), x))
    jobs.flight.enable(capacity=64)
    jm, jother = JMeanSquaredError(), JMeanSquaredError()
    jm.update(*_j(x, x))
    jother.update(*_j(x, x))
    jm.merge_state(jother)
    jpoisoned = JMeanSquaredError(nan_policy="count")
    jpoisoned.update(*_j(np.array([np.nan, 1.0, 2.0], np.float32), x))

    def view(evs, kinds=("dispatch", "merge", "nonfinite_inputs")):
        return [{k: v for k, v in e.items() if k not in ("seq", "ts_us")} for e in evs if e["kind"] in kinds]

    assert view(flight.events()) == view(jobs.flight.events())
    assert view(flight.events())[0] == {"kind": "dispatch", "metric": "MeanSquaredError", "avals": ["3:float32"] * 2}


def test_flight_dump_schema_and_state_reports(tmp_path, surfaces):
    flight.enable(capacity=8)
    m = MeanSquaredError(device=CPU)
    m.update(*_t(np.ones(3, np.float32), np.zeros(3, np.float32)))
    flight.note_state_source(m)
    path = str(tmp_path / "flight.json")
    assert flight.dump(path) == path
    payload = json.loads(open(path).read())
    assert set(payload) == {"schema_version", "dumped_unix", "anchor_us", "capacity", "events", "state_reports"}
    assert payload["schema_version"] == jobs.flight.DUMP_SCHEMA_VERSION == flight.DUMP_SCHEMA_VERSION
    assert payload["capacity"] == 8
    assert [e["kind"] for e in payload["events"]] == ["dispatch", "scope"]  # the update's timed tm.update range
    assert payload["state_reports"][0]["metric"] == "MeanSquaredError"
    assert flight.dump(str(tmp_path / "no-such-dir" / "x.json")) is None
    flight.disable()
    assert flight.dump(str(tmp_path / "y.json")) is None


def test_flight_dump_never_blocks_on_a_held_lock(tmp_path, surfaces):
    flight.enable(capacity=8)
    m = MeanSquaredError(device=CPU)
    m.update(*_t(np.ones(3, np.float32), np.zeros(3, np.float32)))
    flight.note_state_source(m)
    path = str(tmp_path / "flight.json")
    assert flight._LOCK.acquire(timeout=5)  # a thread stalled inside note_state_source
    try:
        result = {}
        t = threading.Thread(target=lambda: result.setdefault("path", flight.dump(path)), daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "dump blocked on the lock of a stalled thread"
    finally:
        flight._LOCK.release()
    assert result["path"] == path
    assert json.loads(open(path).read())["state_reports"][0]["metric"] == "MeanSquaredError"


def test_ckpt_integration_dump_rides_the_committed_step(tmp_path, surfaces):
    flight.enable(capacity=64, ckpt_integration=True)
    m = MeanSquaredError(device=CPU)
    m.update(*_t(np.ones(3, np.float32), np.zeros(3, np.float32)))
    handle = m.save_checkpoint(str(tmp_path / "series"))
    step_dir = handle.result(timeout=60)
    payload = json.loads(open(os.path.join(step_dir, "flight-h0000.json")).read())
    kinds = [e["kind"] for e in payload["events"]]
    assert "dispatch" in kinds and "ckpt_save_begin" in kinds and "ckpt_save_commit" not in kinds
    assert payload["state_reports"][0]["metric"] == "MeanSquaredError"
    assert any(e["kind"] == "ckpt_save_commit" and e["committed"] for e in flight.events())
    flight.disable()
    flight.enable(capacity=64)
    step_dir = m.save_checkpoint(str(tmp_path / "series")).result(timeout=60)
    assert not [f for f in os.listdir(step_dir) if f.startswith("flight")]


_PREEMPT_CHILD = r"""
import os, signal, sys
import numpy as np
import torch
from metrics_tpu_torch.obs import flight
from metrics_tpu_torch.ckpt import manager
from metrics_tpu_torch.classification import MulticlassAccuracy

dump_path, series = sys.argv[1], sys.argv[2]
calls = []
signal.signal(signal.SIGUSR1, lambda s, f: calls.append("prev"))
flight.enable(capacity=32, dump_path=dump_path, install_handlers=True, signals=(signal.SIGTERM, signal.SIGUSR1))
flight.record("probe")
os.kill(os.getpid(), signal.SIGUSR1)  # chained: our dump, then the previous handler
assert calls == ["prev"], calls
os.remove(flight.failure_dump_path())

def killing_commit(*a, **k):
    os.kill(os.getpid(), signal.SIGTERM)  # the preemption lands between update and commit
    raise AssertionError("unreachable: SIGTERM ends the process")

manager._try_commit = killing_commit
m = MulticlassAccuracy(num_classes=5, average="micro", validate_args=False, device="cpu")
lbl = torch.arange(10, dtype=torch.int32) % 5
for _ in range(3):
    m.update(lbl, lbl)
manager.save_checkpoint(m, series)
print("SHOULD-NOT-REACH", flush=True)
"""


def test_failure_handlers_chain_and_dump_on_sigterm_in_a_subprocess(tmp_path):
    dump_path = str(tmp_path / "flight-dump.json")
    series_dir = str(tmp_path / "series")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PREEMPT_CHILD, dump_path, series_dir], capture_output=True,
                          text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == -signal.SIGTERM, (proc.returncode, proc.stdout, proc.stderr)
    assert "SHOULD-NOT-REACH" not in proc.stdout
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight-dump-h0000-p")]
    assert len(dumps) == 1, (os.listdir(tmp_path), proc.stderr)
    kinds = [e["kind"] for e in json.loads(open(tmp_path / dumps[0]).read())["events"]]
    assert kinds.count("dispatch") == 3 and "ckpt_save_begin" in kinds and "ckpt_save_commit" not in kinds
    committed = [d for d in os.listdir(series_dir) if d.startswith("step_")] if os.path.isdir(series_dir) else []
    assert committed == []


def test_signal_handlers_uninstall_and_excepthook_chains(tmp_path, surfaces):
    calls = []
    prev = signal.signal(signal.SIGUSR2, lambda s, f: calls.append("prev"))
    prev_hook = sys.excepthook
    try:
        flight.enable(capacity=8, dump_path=str(tmp_path / "sig.json"), install_handlers=True,
                      signals=(signal.SIGUSR2,))
        assert sys.excepthook is flight._on_unhandled
        os.kill(os.getpid(), signal.SIGUSR2)
        assert calls == ["prev"] and os.path.exists(flight.failure_dump_path())
        flight.disable()
        assert sys.excepthook is prev_hook
        calls.clear()
        os.kill(os.getpid(), signal.SIGUSR2)
        assert calls == ["prev"]
    finally:
        signal.signal(signal.SIGUSR2, prev)
        sys.excepthook = prev_hook


# ---------------------------------------------------------------- state reports

#: the states whose dtype the port widens to int64 (listed deviations of earlier slices)
_INT64_STATES = {("MeanSquaredError", "total"), *((m, s) for m in ("MulticlassAccuracy", "BinaryAccuracy",
                                                                      "BinaryPrecision") for s in ("tp", "fp", "tn", "fn"))}


def _report_pairs():
    preds = np.array([0.1, 0.9, 0.4, 0.7], np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)
    cls_preds, cls_target = np.array([0, 1, 2, 2], np.int32), np.array([0, 1, 1, 2], np.int32)
    return [
        (MeanSquaredError(device=CPU), JMeanSquaredError(), (preds, preds[::-1].copy())),
        (BinaryAUROC(cat_capacity=16, device=CPU), JBinaryAUROC(cat_capacity=16), (preds, labels)),
        (BinaryAUROC(device=CPU), JBinaryAUROC(), (preds, labels)),
        (MulticlassAccuracy(num_classes=3, device=CPU), JMulticlassAccuracy(num_classes=3), (cls_preds, cls_target)),
        (MulticlassAccuracy(num_classes=3, fleet_size=2, device=CPU),
         JMulticlassAccuracy(num_classes=3, fleet_size=2), (cls_preds, cls_target)),
    ]


def _assert_rows_match(report, jreport):
    assert {k: v for k, v in report.items() if k != "states" and k != "total_nbytes"} == {
        k: v for k, v in jreport.items() if k != "states" and k != "total_nbytes"}
    for row, jrow in zip(report["states"], jreport["states"], strict=True):
        assert row["sharding"] is None and row["layout"] is None and row["device"] == CPU
        same = {k: v for k, v in row.items() if k not in ("sharding", "layout", "device", "dtype", "nbytes", "shape")}
        jsame = {k: v for k, v in jrow.items() if k not in ("sharding", "layout", "dtype", "nbytes", "shape")}
        assert same == jsame
        assert (list(row["shape"]) if row["kind"] != "list" else row["shape"]) == (
            list(jrow["shape"]) if jrow["kind"] != "list" else jrow["shape"])
        if row["dtype"] == jrow["dtype"]:
            assert row["nbytes"] == jrow["nbytes"]
        else:
            assert (report["metric"], row["name"]) in _INT64_STATES and row["dtype"] == "int64"
            assert row["nbytes"] == 2 * jrow["nbytes"]


def test_state_report_rows_equal_the_jax_package():
    for port, jax_metric, batch in _report_pairs():
        kwargs = {}
        if port.fleet_size is not None:
            kwargs = {"stream_ids": np.array([0, 1, 1, 0], np.int32)}
        port.update(*_t(*batch), **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        jax_metric.update(*_j(*batch), **{k: jnp.asarray(v) for k, v in kwargs.items()})
        _assert_rows_match(port.state_report(), jax_metric.state_report())
        assert render_state_report(port.state_report()).startswith(type(port).__name__)


def test_collection_summary_equals_the_jax_package():
    preds, target = np.array([0.2, 0.8, 0.6], np.float32), np.array([0, 1, 0], np.int32)
    from metrics_tpu.classification import BinaryAccuracy as JBinaryAccuracy
    from metrics_tpu.classification import BinaryPrecision as JBinaryPrecision
    from metrics_tpu_torch.classification import BinaryAccuracy, BinaryPrecision

    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU), "prec": BinaryPrecision(device=CPU),
                             "auroc": BinaryAUROC(cat_capacity=8, device=CPU)}, fused=True)
    jcoll = JMetricCollection({"acc": JBinaryAccuracy(), "prec": JBinaryPrecision(),
                               "auroc": JBinaryAUROC(cat_capacity=8)}, fused=True)
    coll.update(*_t(preds, target))
    jcoll.update(*_j(preds, target))
    summary, jsummary = coll.summary(), jcoll.summary()
    for name in jsummary["metrics"]:
        _assert_rows_match(summary["metrics"][name], jsummary["metrics"][name])
    # the groups are the JAX package's; their bytes are the port's own rows' (int64 counts)
    assert [(g["leader"], g["members"]) for g in summary["compute_groups"]] == [
        (g["leader"], g["members"]) for g in jsummary["compute_groups"]]
    totals = {name: r["total_nbytes"] for name, r in summary["metrics"].items()}
    assert [g["shared_nbytes"] for g in summary["compute_groups"]] == [totals[g["leader"]] for g in
                                                                       summary["compute_groups"]]
    assert summary["total_nbytes"] + summary["nbytes_saved_by_groups"] == sum(totals.values())
    assert summary["fused"]["launches"] == 1
    assert "compute groups:" in render_collection_summary(summary)


# -------------------------------------------------------------------- health


def _latencies(n=1000, seed=3):
    rng = np.random.RandomState(seed)
    return (np.exp(rng.normal(-7.0, 1.5, n))).tolist()  # seconds, around a millisecond


def test_health_quantiles_are_the_jax_monitors_slots(surfaces):
    lat = _latencies()
    mon = health.enable(flush_every=64, device=CPU)
    jmon = jobs.health.enable(flush_every=64)
    for i, s in enumerate(lat):
        key = ("ingest", "q") if i % 3 else ("update", "MeanSquaredError")
        mon.observe_latency(*key, s)
        jmon.observe_latency(*key, s)
    sk, jsk = health.export_sketches(), jobs.health.export_sketches()
    assert sk.keys() == jsk.keys()
    for key in jsk:
        assert sk[key]["count"] == jsk[key]["count"]
        assert sk[key]["params"] == jsk[key]["params"]
        assert sk[key]["state"] == jsk[key]["state"], key  # the same slot for every value
    rep, jrep = health.report(), jobs.health.report()
    assert rep["latency_us"].keys() == jrep["latency_us"].keys()
    for key, row in jrep["latency_us"].items():
        for field, value in row.items():
            if field.endswith("_us"):
                assert rep["latency_us"][key][field] == pytest.approx(value, rel=1e-6, abs=1e-3)
            else:
                assert rep["latency_us"][key][field] == value
    assert rep["hbm_watermark_bytes"] is None  # the CPU keeps no memory statistics


def test_health_residual_flush_pads_with_nan_and_keeps_the_gate_clean(surfaces):
    mon = health.enable(flush_every=64, device=CPU)
    for _ in range(5):
        mon.observe_latency("update", "X", 1e-3)
    row = health.report()["latency_us"]["update/X"]
    assert row["count"] == 5 and row["p50_us"] == pytest.approx(1000, rel=0.02)
    assert "QuantileSketch" not in obs.snapshot()  # the flush never counts itself
    mon.note_hbm(100)
    mon.note_hbm(50)
    m = MeanSquaredError(device=CPU)
    health.observe_state_bytes(m)
    assert mon.hbm_watermark_bytes == 100


def test_a_flush_on_one_thread_leaves_the_other_threads_recording(surfaces, monkeypatch):
    """A sketch flush records nothing from its own thread, and turns the gate off for
    nobody: the fused launches and the ingest tick that other threads run while it
    flushes count, with their flight events."""
    import time

    from metrics_tpu_torch.core.fused import canonical_collection
    from metrics_tpu_torch.serve import IngestQueue

    registry.enable(clear=True)
    flight.enable(capacity=256)
    mon = health.enable(flush_every=4, device=CPU)
    inside, done = threading.Event(), threading.Event()
    own_stream = health.HealthMonitor._on_own_stream

    def paused(self):
        if threading.current_thread().name == "flusher":
            inside.set()
            done.wait(30)
        return own_stream(self)

    monkeypatch.setattr(health.HealthMonitor, "_on_own_stream", paused)
    flusher = threading.Thread(
        target=lambda: [mon.observe_latency("update", "F", 1e-3) for _ in range(4)], name="flusher")
    queue = IngestQueue(MeanSquaredError(device=CPU), start=False, name="during-flush")
    # the tick counts itself, then waits for the monitor's lock until the flush ends
    ticker = threading.Thread(target=lambda: (queue.enqueue(torch.ones(8), torch.zeros(8)), queue.flush()))
    try:
        flusher.start()
        assert inside.wait(30)
        coll = canonical_collection(True, device=CPU)
        for _ in range(3):
            coll.update(torch.rand(16), torch.randint(0, 2, (16,)))
        ticker.start()
        deadline = time.monotonic() + 30
        while registry.REGISTRY.get("ingest", "ticks") < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert flusher.is_alive() and not done.is_set()  # all of the above ran during the flush
        assert registry.REGISTRY.get("fused", "launches") == 3 and registry.REGISTRY.get("ingest", "ticks") == 1
        kinds = [e["kind"] for e in flight.events()]
        assert kinds.count("fused_launch") == 3 and kinds.count("ingest_tick") == 1
    finally:
        done.set()
        flusher.join(30)
        ticker.join(30) if ticker.ident else None
        queue.close()
    assert not flusher.is_alive() and not ticker.is_alive(), "a flush or a tick did not finish within 30 s"
    report = health.report()["latency_us"]
    assert report["update/F"]["count"] == 4 and report["ingest/during-flush"]["count"] == 1
    assert "QuantileSketch" not in registry.REGISTRY.snapshot()  # the flushes never count themselves


def _fill_registries():
    for reg in (registry.REGISTRY, jobs.REGISTRY):
        reg.inc("MeanSquaredError", "dispatches", 12)
        reg.inc("fused", "dispatches", 3)
        reg.inc("MeanSquaredError", "nonfinite_rows", 4)
        reg.inc("StreamMean", "retraces", 2)
        reg.inc('we"ird\\scope', "n")
        reg.observe_duration("bench", "step", 0.25)
        reg.observe_duration("bench", "step", 0.5)


@pytest.mark.parametrize("budget", [
    {"max_launches_per_step": 1.0},
    {"max_launches_per_step": 100.0},
    {"max_retraces_per_window": 1},
    {"max_nonfinite_rows": 3},
    {"max_nonfinite_rows": 4},
    {"p99_update_latency_ms": 1e-6},
    {"p99_ingest_latency_ms": 1e-6},
    {"p99_ingest_latency_ms": 1e6},
])
def test_slo_verdicts_equal_the_jax_package(budget, surfaces):
    mon = health.enable(flush_every=8, device=CPU)
    jmon = jobs.health.enable(flush_every=8)
    for s in _latencies(40):
        for m in (mon, jmon):
            m.observe_latency("update", "MeanSquaredError", s)
            m.observe_latency("ingest", "q", s)
    health.set_slo(action=lambda v: None, **budget)
    jobs.health.set_slo(action=lambda v: None, **budget)
    _fill_registries()
    got, want = health.check_slos(steps=5), jobs.health.check_slos(steps=5)
    assert [(v["slo"], v["budget"], v["detail"]) for v in got] == [(v["slo"], v["budget"], v["detail"]) for v in want]
    for v, w in zip(got, want):
        assert v["measured"] == pytest.approx(w["measured"], rel=1e-5)


def test_slo_actions_warn_raise_and_require_a_monitor(surfaces):
    with pytest.raises(RuntimeError, match="requires an enabled monitor"):
        health.set_slo(max_nonfinite_rows=0)
    health.enable(device=CPU)
    registry.REGISTRY.inc("M", "nonfinite_rows", 2)
    health.set_slo(max_nonfinite_rows=1, action="warn")
    with pytest.warns(health.SLOViolationWarning, match="max_nonfinite_rows"):
        health.check_slos()
    health.set_slo(max_nonfinite_rows=1, action="raise")
    with pytest.raises(health.SLOBudgetExceeded):
        health.check_slos()
    with pytest.raises(ValueError):
        health.SLOBudget(action="explode")


# -------------------------------------------------------------------- series


def test_series_records_deltas_bounded_ticks_and_slos(surfaces):
    with pytest.raises(ValueError):
        series.TelemetrySampler(interval_s=0)
    smp = series.enable(start_thread=False, capacity=3)
    registry.REGISTRY.inc("ingest", "ticks", 5)
    first = smp.tick()
    registry.REGISTRY.inc("ingest", "ticks", 2)
    second = smp.tick()
    assert first["counters"]["ingest"]["ticks"] == 5 and second["counters"]["ingest"]["ticks"] == 2
    for _ in range(4):
        smp.tick()
    assert len(series.ticks()) == 3 and smp.ticks_taken == 6
    assert smp.series("ingest", "ticks")[-1][1] == 0.0
    health.enable(device=CPU)
    health.set_slo(max_nonfinite_rows=0, action=lambda v: None)
    registry.REGISTRY.inc("M", "nonfinite_rows", 1)
    assert smp.tick()["slo_violations"][0]["slo"] == "max_nonfinite_rows"
    assert smp.slo_violations_total == 1
    series.disable()
    series.disable()
    assert series.sampler() is None and series.ticks() == []


def test_series_thread_ticks_and_stops(surfaces):
    smp = series.enable(interval_s=0.01)
    deadline = __import__("time").monotonic() + 10
    while smp.ticks_taken < 2:
        assert __import__("time").monotonic() < deadline
        __import__("time").sleep(0.01)
    series.disable()
    assert smp._thread is None


# --------------------------------------------------------------- exposition


def _samples(page):
    return sorted(line for line in page.splitlines() if line and not line.startswith("#"))


def test_render_samples_equal_the_jax_package_for_equal_contents(surfaces):
    assert prom.render() == jobs.prom.render()  # both gates off: the one gauge
    obs.enable()
    jobs.enable()
    _fill_registries()
    mon = health.enable(flush_every=4, device=CPU)
    jmon = jobs.health.enable(flush_every=4)
    for i in range(16):
        mon.observe_latency("update", "StreamMean", 0.001 * (i + 1))
        jmon.observe_latency("update", "StreamMean", 0.001 * (i + 1))
    page, jpage = prom.render(), jobs.prom.render()
    assert prom.validate_exposition(page) == jobs.prom.validate_exposition(jpage) > 5
    assert _samples(page) == _samples(jpage)
    assert 'tm_events_total{name="dispatches",scope="fused"} 3' in page
    assert 'tm_latency_microseconds{metric="StreamMean",op="update",quantile="0.5"}' in page


def test_server_families_equal_the_jax_package(surfaces):
    obs.enable()
    jobs.enable()
    cfg = {"collections": [{"name": "a", "metrics": {"mse": "MeanSquaredError"}},
                           {"name": "b", "metrics": {"mse": "MeanSquaredError"}}],
           "ticker": {"adaptive": False}}
    rng = np.random.RandomState(0)
    batches = [(rng.rand(8).astype(np.float32), rng.rand(8).astype(np.float32)) for _ in range(4)]
    with tserver.MetricsServer(dict(cfg, device=CPU), ticker=False) as srv, \
            jserve.MetricsServer(cfg, ticker=False) as jsrv:
        for b in batches:
            srv.enqueue("a", *b)
            jsrv.enqueue("a", *b)
        srv._tick_round()
        jsrv._tick_round()

        def served(page):
            return [s for s in _samples(page) if s.startswith(("tm_server", "tm_ingest"))]

        page, jpage = prom.render(), jobs.prom.render()
        assert prom.validate_exposition(page) > 0
        assert served(page) == served(jpage)
        assert 'tm_server_state{server="metrics-server",state="ready"} 1' in page


def test_port_families_ignore_live_jax_queues_and_servers(surfaces):
    obs.enable()
    cfg = {"collections": [{"name": "a", "metrics": {"mse": "MeanSquaredError"}}]}
    with jserve.MetricsServer(cfg, ticker=False), \
            jserve.IngestQueue(JMeanSquaredError(), start=False, name="jax-queue") as jq:
        jq.enqueue(jnp.ones(3), jnp.ones(3))
        assert "tm_server_state" in jobs.prom.render() and "jax-queue" in jobs.prom.render()
        page = prom.render()
        assert "tm_server" not in page and "tm_ingest" not in page and "jax-queue" not in page
        health.enable(device=CPU)
        health.set_slo(max_queue_depth=0, action="raise")
        assert health.check_slos() == []  # the JAX queue's backlog of 1 is not read


_MALFORMED = [
    "tm_x 1\n",
    "# TYPE tm_x counter\ntm_x 1\n",
    "# TYPE tm_x gauge\ntm_x{bad-label=\"v\"} 1\n",
    "# TYPE tm_x gauge\ntm_x abc\n",
    "# TYPE tm_x summary\ntm_x 1\n",
    "# TYPE tm_x gauge\n# TYPE tm_x gauge\ntm_x 1\n",
    "tm_y 1\n# TYPE tm_y gauge\ntm_y 1\n",
    "# TYPE tm_x wat\n",
    "# HELP tm_x a\n# HELP tm_x b\n",
    "# TYPE tm_x gauge\ntm_x_total 1\n",
    "# TYPE tm_x gauge\ntm_x{a=\"1\",a=\"2\"} 1\n",
    "# BOGUS tm_x\n",
    5,
]


@pytest.mark.parametrize("page", _MALFORMED, ids=range(len(_MALFORMED)))
def test_validator_rejects_what_the_jax_validator_rejects(page):
    with pytest.raises(ValueError):
        jobs.prom.validate_exposition(page)
    with pytest.raises(ValueError):
        prom.validate_exposition(page)


def test_validator_accepts_what_the_jax_validator_accepts(surfaces):
    obs.enable()
    registry.REGISTRY.inc('we"ird\\scope', "n")
    page = prom.render()
    assert prom.validate_exposition(page) == jobs.prom.validate_exposition(page) >= 2
    good = ("# HELP tm_s s\n# TYPE tm_s summary\ntm_s{quantile=\"0.5\"} 1\ntm_s_count 2\ntm_s_sum 3\n"
            "# TYPE tm_c counter\ntm_c_total +Inf\n# TYPE tm_g gauge\ntm_g NaN 1700000000\n")
    assert prom.validate_exposition(good) == jobs.prom.validate_exposition(good) == 5


def _get(host, port, path):
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode(), None


def test_scrape_endpoint_and_readiness(surfaces):
    obs.enable()
    registry.REGISTRY.inc("fleet", "routed_launches")
    host, port = prom.start_server(port=0)
    assert prom.server_active()
    status, body, ctype = _get(host, port, "/metrics")
    assert status == 200 and ctype == prom.CONTENT_TYPE and "routed_launches" in body
    assert prom.validate_exposition(body) > 0
    assert _get(host, port, "/healthz")[:2] == (200, "ok\n")
    provider = lambda: (503, "starting\n")  # noqa: E731
    prom.set_readiness(provider)
    assert _get(host, port, "/healthz")[:2] == (503, "starting\n")
    prom.clear_readiness(lambda: None)  # not the installed one: kept
    assert prom.readiness_probe() == (503, "starting\n")
    prom.set_readiness(lambda: 1 / 0)
    assert prom.readiness_probe()[0] == 500
    prom.clear_readiness()
    assert _get(host, port, "/nope")[0] == 404
    prom.stop_server()
    assert not prom.server_active()
