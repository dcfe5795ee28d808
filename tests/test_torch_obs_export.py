"""metrics_tpu_torch.obs scopes, retrace detection, the Chrome trace and snapshot
exports and cross-host aggregation against the JAX package's, on the CPU.

- Scopes: the same calls open the same ``tm.*`` ranges (the registry's ``scopes``
  counts), and ``obs.trace`` writes a ``torch.profiler`` Chrome trace holding them.
- Retrace detection: fingerprints of the same inputs are equal, and the same
  sequence of update shapes gives the same ``retraces``/``retrace_signatures``/
  ``retrace_warnings`` counters and warning text (after the package's name); the
  fused engine's step-cache misses run the same check.
- The JAX package's ``validate_chrome_trace`` and ``validate_snapshot`` accept the
  port's exports, whose tracks and fields are the JAX package's.
- Aggregation: a JAX-published ``obs-h0.json`` and a port-published ``obs-h1.json``
  in one directory aggregate, through either package, to the same counters and
  bit-equal sketch quantiles; the ``agg.*`` fault sites and the tolerant mode's
  deadline.

After every test no flight ring, health monitor, tracer or fault schedule is left on.
"""
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu.obs as jobs
from metrics_tpu.classification import BinaryAccuracy as JBinaryAccuracy
from metrics_tpu.core.collections import MetricCollection as JMetricCollection
from metrics_tpu.regression import MeanAbsoluteError as JMeanAbsoluteError
from metrics_tpu.regression import MeanSquaredError as JMeanSquaredError
from metrics_tpu.serve.ingest import IngestQueue as JIngestQueue
from metrics_tpu_torch import fault, obs
from metrics_tpu_torch.classification import BinaryAccuracy
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.obs import aggregate, export, recompile, registry
from metrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError
from metrics_tpu_torch.serve import IngestQueue

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    for pkg in (obs, jobs):
        pkg.flow.disable()
        pkg.flight.disable()
        pkg.health.disable()
        pkg.disable()
        pkg.REGISTRY.clear()
        pkg.reset_class_detector()


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    _reset()
    yield
    left = fault.current()
    _reset()
    assert left is None


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)


# ---------------------------------------------------------------------- scopes


def _scoped_calls(m, coll, to):
    p, t = _rows(8)
    m.update(*to(p, t))
    m.update(*to(p, t))
    m.forward(*to(p, t))
    m.compute()
    coll.update(*to(p, t))
    coll.forward(*to(p, t))
    coll.compute()


def test_scopes_are_the_jax_packages():
    obs.enable()
    jobs.enable()
    _scoped_calls(MeanSquaredError(device=CPU),
                  MetricCollection([MeanSquaredError(device=CPU), MeanAbsoluteError(device=CPU)]), _t)
    _scoped_calls(JMeanSquaredError(), JMetricCollection([JMeanSquaredError(), JMeanAbsoluteError()]),
                  lambda *x: x)
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    assert snap["scopes"] == jsnap["scopes"]
    assert snap["scopes"]["tm.collection.forward"] == 1 and snap["scopes"]["tm.update/MeanSquaredError"] >= 4
    for scope in ("MeanSquaredError", "MeanAbsoluteError"):
        for name in ("updates", "dispatches", "computes", "forwards", "compute_cache_hits"):
            assert snap[scope].get(name) == jsnap[scope].get(name), (scope, name)


def test_fused_steps_are_the_jax_packages():
    """One ``tm.fused/step`` range and the engine's counters a step. (The JAX engine
    also runs each group's update eagerly at a miss, to find a group that cannot
    fuse; the port does that only after a failed capture, so the members'
    ``tm.update`` counts differ at a miss.)"""
    obs.enable()
    jobs.enable()
    p, t = _rows(8)
    coll, jcoll = MetricCollection([MeanSquaredError(device=CPU)], fused=True), \
        JMetricCollection([JMeanSquaredError()], fused=True)
    for _ in range(3):
        coll.update(*_t(p, t))
        jcoll.update(p, t)
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    assert snap["scopes"]["tm.fused/step"] == jsnap["scopes"]["tm.fused/step"] == 3
    assert snap["scopes"]["tm.collection.update"] == jsnap["scopes"]["tm.collection.update"] == 3
    for name in ("cache_misses", "cache_hits", "launches", "dispatches"):
        assert snap["fused"].get(name) == jsnap["fused"].get(name), name


def test_timed_scopes_feed_the_flight_ring_and_the_health_sketches():
    obs.flight.enable(capacity=64)
    obs.health.enable(device=CPU)
    m = MeanSquaredError(device=CPU)
    m.update(*_t(*_rows(8)))
    m.compute()
    scopes = [e for e in obs.flight.events() if e["kind"] == "scope"]
    assert [e["name"] for e in scopes] == ["tm.update/MeanSquaredError", "tm.compute/MeanSquaredError"]
    assert all(e["dur_us"] > 0 for e in scopes)
    rep = obs.health.report()["latency_us"]
    assert rep["update/MeanSquaredError"]["count"] == 1 and rep["compute/MeanSquaredError"]["count"] == 1


def test_trace_writes_a_profiler_chrome_trace_with_the_ranges(tmp_path):
    m = MeanSquaredError(device=CPU)
    with obs.trace(str(tmp_path / "prof")) as path:
        assert registry._ENABLED
        m.update(*_t(*_rows(8)))
    assert not registry._ENABLED  # the gate goes back to how it was
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert "tm.update/MeanSquaredError" in {e.get("name") for e in events}


# -------------------------------------------------------------- retrace storms


def _shapes_sequence(make, to):
    """Two instances of one class, shapes chosen to retrace, storm and churn."""
    a, b = make(), make()
    for n in (8, 8, 16, 4, 4):
        a.update(*to(*_rows(n)))
    for n in (8, 32):
        b.update(*to(*_rows(n)))
    p, t = _rows(8)
    a.update(*to(p.astype(np.float64), t.astype(np.float64)))  # a dtype flip


def _storm_text(w):
    return str(w.message).split(": ", 1)[1]


def test_retrace_counters_and_warnings_are_the_jax_packages():
    obs.enable()
    jobs.enable()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        _shapes_sequence(lambda: MeanSquaredError(device=CPU), _t)
    with warnings.catch_warnings(record=True) as jgot:
        warnings.simplefilter("always")
        _shapes_sequence(JMeanSquaredError, lambda *x: x)
    counters = {k: v for k, v in obs.snapshot()["MeanSquaredError"].items() if k.startswith("retrace")}
    jcounters = {k: v for k, v in jobs.snapshot()["MeanSquaredError"].items() if k.startswith("retrace")}
    assert counters == jcounters
    assert counters["retraces"] >= 3 and counters["retrace_warnings"] == 1 and counters["retrace_signatures"] >= 3
    storms = [w for w in got if "metrics_tpu_torch.obs:" in str(w.message)]
    jstorms = [w for w in jgot if "metrics_tpu.obs:" in str(w.message)]
    assert [_storm_text(w) for w in storms] == [_storm_text(w) for w in jstorms] and len(storms) == 2
    assert all(str(w.message).startswith("metrics_tpu_torch.obs: ") for w in storms)


def test_fingerprints_are_the_jax_packages():
    p, t = _rows(8)
    args, kwargs = (p, t.astype(np.int64)), {"k": 3, "flag": True, "nested": [p, {"x": None}]}
    targs = _t(*args)
    tkwargs = {"k": 3, "flag": True, "nested": [_t(p)[0], {"x": None}]}
    assert recompile.fingerprint(targs, tkwargs) == jobs.fingerprint(args, kwargs)
    assert recompile.nbytes_of(targs[1]) == 64 and recompile.nbytes_of(np.zeros(3, np.float32)) == 12
    assert recompile.nbytes_of(object()) == 0


def test_fused_cache_misses_run_the_retrace_check_like_the_jax_package():
    obs.enable()
    jobs.enable()
    coll = MetricCollection([MeanSquaredError(device=CPU)], fused=True)
    jcoll = JMetricCollection([JMeanSquaredError()], fused=True)
    for n in (8, 8, 16, 4):
        coll.update(*_t(*_rows(n)))
        jcoll.update(*_rows(n))
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    assert snap["fused"]["cache_misses"] == jsnap["fused"]["cache_misses"] == 3
    assert snap["FusedCollectionUpdate"] == jsnap["FusedCollectionUpdate"]
    assert snap["FusedCollectionUpdate"]["retraces"] == 2


def test_detector_resets():
    obs.enable()
    m = MeanSquaredError(device=CPU)
    m.update(*_t(*_rows(8)))
    m.update(*_t(*_rows(4)))
    assert registry.REGISTRY.get("MeanSquaredError", "retraces") == 1
    obs.reset_detector(m)
    obs.reset_class_detector(MeanSquaredError)
    m.update(*_t(*_rows(4)))
    assert registry.REGISTRY.get("MeanSquaredError", "retraces") == 1
    assert m.__dict__["_obs_fingerprints"] and recompile._CLASS_FINGERPRINTS["MeanSquaredError"]


# ---------------------------------------------------------- the Chrome trace


def _two_queues(queue_cls, metric_cls, to):
    p, t = np.asarray([0.1, 0.9, 0.8, 0.2], np.float32), np.asarray([0, 1, 1, 0])
    for name in ("replica-a", "replica-b"):
        with queue_cls(metric_cls(), name=name, start=False) as q:
            q.enqueue(*to(p, t))
            q.flush()


def _tracks(trace):
    return sorted(e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M" and e["name"] == "thread_name")


def test_chrome_trace_validates_and_keeps_the_jax_tracks(tmp_path):
    obs.flight.enable(capacity=512)
    jobs.flight.enable(capacity=512)
    obs.flow.enable(device=CPU)
    jobs.flow.enable()
    _two_queues(IngestQueue, lambda: BinaryAccuracy(device=CPU), _t)
    _two_queues(JIngestQueue, JBinaryAccuracy, lambda *x: x)
    assert obs.flow.wait_idle(10.0) and jobs.flow.wait_idle(10.0)
    path = str(tmp_path / "trace.json")
    trace = obs.export_chrome_trace(path)
    with open(path) as fh:
        assert json.load(fh)["traceEvents"] == json.loads(json.dumps(trace["traceEvents"], default=str))
    assert obs.validate_chrome_trace(trace) == len(trace["traceEvents"])
    assert jobs.validate_chrome_trace(trace) == len(trace["traceEvents"])  # the JAX validator accepts it
    jtrace = jobs.export_chrome_trace(str(tmp_path / "jtrace.json"))
    assert _tracks(trace) == _tracks(jtrace)
    assert {"ingest_tick/replica-a", "ingest_tick/replica-b", "launcher/replica-a"} <= set(_tracks(trace))
    arrows = sorted(e["ph"] for e in trace["traceEvents"] if e.get("cat") == "flow" and e["ph"] in "stf")
    assert arrows == sorted(e["ph"] for e in jtrace["traceEvents"] if e.get("cat") == "flow" and e["ph"] in "stf")
    assert trace["otherData"]["exporter"] == "metrics_tpu_torch.obs.trace"


def test_chrome_trace_validator_rejections():
    with pytest.raises(ValueError, match="traceEvents"):
        obs.validate_chrome_trace({})
    with pytest.raises(ValueError, match="unsupported ph"):
        obs.validate_chrome_trace({"traceEvents": [{"ph": "Q", "name": "x", "pid": 1, "tid": 1}]})
    with pytest.raises(ValueError, match="flow event"):
        obs.validate_chrome_trace({"traceEvents": [{"ph": "s", "name": "x", "pid": 1, "tid": 1, "ts": 0.0}]})
    with pytest.raises(ValueError, match="dur"):
        obs.validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0.0}]})


# --------------------------------------------------------------- the snapshot


def test_snapshot_export_validates_in_both_packages(tmp_path):
    obs.enable()
    m = MeanSquaredError(device=CPU)
    m.update(*_t(*_rows(8)))
    with obs.REGISTRY.stopwatch("bench", "step"):
        pass
    line = obs.export_snapshot()
    assert line["schema_version"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 3 and "flows" not in line
    obs.validate_snapshot(line)
    jobs.validate_snapshot(line)
    obs.flow.enable(device=CPU)
    path = str(tmp_path / "snap.jsonl")
    written = obs.dump_jsonl(path, extra={"epoch": 1}, clock=lambda: 12.5)
    obs.dump_jsonl(path)
    with open(path) as fh:
        lines = [json.loads(x) for x in fh]
    assert len(lines) == 2 and lines[0] == json.loads(json.dumps(written, sort_keys=True))
    for rec in lines:
        assert rec["flows"]["open"] == 0
        obs.validate_snapshot(rec)
        jobs.validate_snapshot(rec)
    assert lines[0]["time_unix"] == 12.5 and lines[0]["epoch"] == 1
    for bad in ({"schema_version": 0}, dict(line, enabled=1), dict(line, registry=[]),
                dict(line, flows={"open": True}), dict(line, registry={"s": {"n": "x"}})):
        for validate in (obs.validate_snapshot, jobs.validate_snapshot):
            with pytest.raises(ValueError):
                validate(bad)


def test_the_ports_schema_file_is_the_jax_packages():
    with open(os.path.join(os.path.dirname(export.__file__), "export_schema.json")) as fh:
        port = json.load(fh)
    with open(os.path.join(REPO, "metrics_tpu", "obs", "export_schema.json")) as fh:
        ref = json.load(fh)
    for key in ("$schema", "type", "required", "properties", "additionalProperties"):
        assert port[key] == ref[key], key


# ---------------------------------------------------------------- aggregation


def _observe(monitor, op, seconds):
    for i, s in enumerate(seconds):
        monitor.observe_latency(op, "X", float(s))


def test_mixed_package_hosts_aggregate_to_the_same_fleet(tmp_path):
    rng = np.random.default_rng(5)
    lat0, lat1 = rng.lognormal(-7, 1, 300), rng.lognormal(-6, 0.5, 200)
    jmon = jobs.health.enable()
    mon = obs.health.enable(device=CPU)
    _observe(jmon, "update", lat0)
    _observe(mon, "update", lat1)
    jobs.REGISTRY.inc("MeanSquaredError", "updates", 3)
    obs.REGISTRY.inc("MeanSquaredError", "updates", 4)
    obs.REGISTRY.observe_duration("bench", "step", 0.5)
    jobs.REGISTRY.observe_duration("bench", "step", 0.25)
    d = str(tmp_path / "agg")
    jobs.aggregate.publish(d)  # host 0: the JAX package's snapshot
    snap = obs.aggregate.host_snapshot()
    assert snap["host"] == 0 and snap["world"] == 1
    snap["host"] = 1
    assert obs.aggregate.publish(d, snap).endswith("obs-h0001.json")
    port, ref = obs.aggregate.aggregate_dir(d, expect_world=2), jobs.aggregate.aggregate_dir(d, expect_world=2)
    assert port["counters"] == ref["counters"]
    assert port["counters"]["MeanSquaredError"]["updates"] == 7
    assert port["counters"]["bench"]["step"]["count"] == 2 and port["counters"]["bench"]["step"]["max_s"] == 0.5
    assert port["latency_us"] == ref["latency_us"]  # merged sketches, bit-equal quantiles
    assert port["latency_us"]["update/X"]["count"] == 500
    assert port["latency_sketches"] == ref["latency_sketches"]
    assert [h["host"] for h in port["per_host"]] == [0, 1] and port["world_observed"] == 2
    # the merge is the one sketch of every observation
    one = obs.health.enable(device=CPU)
    _observe(one, "update", np.concatenate([lat0, lat1]))
    assert obs.health.report()["latency_us"]["update/X"] == port["latency_us"]["update/X"]
    fleet = obs.aggregate.fleet_snapshot()
    assert fleet["hosts"] == 1 and fleet["latency_us"]["update/X"]["count"] == 500


def test_aggregate_fault_sites_and_deadline(tmp_path):
    d = str(tmp_path / "agg")
    obs.REGISTRY.inc("s", "n")
    with fault.FaultSchedule(fire_at={"agg.publish": 0}):
        with pytest.raises(fault.InjectedFaultError):
            obs.aggregate.publish(d)
    assert not os.path.exists(d) or not os.listdir(d)
    obs.aggregate.publish(d)
    with fault.FaultSchedule(fire_at={"agg.read": 0}):
        with pytest.raises(fault.InjectedFaultError):
            obs.aggregate.aggregate_dir(d)
    with fault.FaultSchedule(fire_at={"agg.read": 0}):
        with pytest.raises(ValueError, match="min_world"):
            obs.aggregate.aggregate_dir(d, min_world=1)
    t0 = time.monotonic()
    partial = obs.aggregate.aggregate_dir(d, expect_world=3, timeout_s=0.2, poll_interval_s=0.02)
    assert time.monotonic() - t0 < 5.0  # the wait on the missing hosts has its deadline
    assert partial["world_observed"] == 1 and partial["world_expected"] == 3
    with pytest.raises(ValueError, match="expected 3"):
        obs.aggregate.aggregate_dir(d, expect_world=3)
    with pytest.raises(ValueError, match="at least one"):
        aggregate.aggregate([])
    bad = obs.aggregate.host_snapshot()
    other = dict(bad, latency_sketches={"k": {"params": {"bits": 1}, "state": {}, "count": 1}})
    mine = dict(bad, latency_sketches={"k": {"params": {"bits": 2}, "state": {}, "count": 1}})
    with pytest.raises(ValueError, match="disagree"):
        aggregate.aggregate([other, mine])
