"""metrics_tpu_torch.obs.flow (flow tracing) against the JAX package's, on the CPU.

- The same enqueue sequence (``stream_ids``, a coalesced tick, a backpressure drop, a
  forced degrade, a ``close(drain=False)``) gives span trees of the same names, counts,
  parent links, tick fan-in and attribute keys in both packages; times are not
  compared. Each flow's stages sum to its end-to-end latency.
- Synchronous fused flows, sampling, the ``tm_flow_*`` Prometheus families, the health
  rollups and the checkpoint's flow drain against the JAX package's.
- The completion watcher on stand-in events (the CPU has no CUDA event): a late
  completion, a device error and a deadline each close the tick's flows.
- The gate: with obs off (or obs on and no tracer) the flow, retrace and scope entry
  points are never reached on an eager update, a fused step, a fleet update and an
  ingest tick.

After every test no queue or fault schedule is left, and the tracer's watcher thread
has ended. Every wait has a deadline that fails the test.
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu.obs as jobs
from metrics_tpu.classification import BinaryAccuracy as JBinaryAccuracy
from metrics_tpu.classification import MulticlassAccuracy as JMulticlassAccuracy
from metrics_tpu.core.collections import MetricCollection as JMetricCollection
from metrics_tpu.fault.inject import FaultSchedule as JFaultSchedule
from metrics_tpu.regression import MeanSquaredError as JMeanSquaredError
from metrics_tpu.serve.ingest import IngestQueue as JIngestQueue
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.classification import BinaryAccuracy, MulticlassAccuracy
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.obs import flight, flow, health, prom, recompile, registry, scopes
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import IngestQueue, active_queues

CPU = "cpu"
WAIT_S = 10.0


def _reset():
    for pkg in (obs, jobs):
        pkg.flow.disable()
        pkg.flight.disable()
        pkg.health.disable()
        pkg.disable()
        pkg.REGISTRY.clear()


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    _reset()
    yield
    ckpt.wait_for_all_saves(timeout_s=60)
    left = {"queue": active_queues(), "fault": fault.current()}
    watcher = flow._TRACER._watcher if flow._TRACER is not None else None
    _reset()
    assert left == {"queue": [], "fault": None}
    assert watcher is None or not watcher.is_alive()  # disable() joined it


def _enable_both(sample_rate=1):
    obs.flight.enable(capacity=1024)
    jobs.flight.enable(capacity=1024)
    obs.flow.enable(sample_rate=sample_rate, device=CPU)
    jobs.flow.enable(sample_rate=sample_rate)


def _wait_idle(pkg):
    assert pkg.flow.wait_idle(WAIT_S), "the completion watcher did not close every flow in time"


def _batches(n, rows=16, classes=5, fleet=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, classes)).astype(np.float32), rng.integers(0, classes, rows),
             rng.integers(0, fleet, rows)) for _ in range(n)]


def _fleets(batches):
    """The scenario's fleet metric in each package, its routed step compiled by one
    update before tracing starts (the JAX package compiles it on the CPU, the port
    runs it eagerly there), then reset."""
    port = MulticlassAccuracy(num_classes=5, average="micro", fleet_size=8, device=CPU)
    ref = JMulticlassAccuracy(num_classes=5, average="micro", fleet_size=8)
    p, t, s = batches[0]
    port.update(*_torch(p, t), stream_ids=_torch(s)[0])
    ref.update(p, t, stream_ids=s)
    port.reset()
    ref.reset()
    return port, ref


def _drive(pkg_queue, metric, schedule_cls, to, batches):
    """The scenario, the same in both packages: one coalesced tick of 3 batches, a
    ring of 4 that drops its oldest of 5, a tick degraded by an injected fault, a
    read, and a close that drops the 2 batches staged."""
    b = iter(batches)
    q = pkg_queue(metric, name="tenants", capacity=4, backpressure="drop_oldest", start=False)
    try:
        for _ in range(3):
            p, t, s = next(b)
            q.enqueue(*to(p, t), stream_ids=to(s)[0])
        q.flush()
        for _ in range(5):
            p, t, s = next(b)
            q.enqueue(*to(p, t), stream_ids=to(s)[0])
        q.flush()
        with schedule_cls(fire_at={"ingest.tick": 0}):
            for _ in range(2):
                p, t, s = next(b)
                q.enqueue(*to(p, t), stream_ids=to(s)[0])
            with _degrade_warnings():
                q.flush()
        q.compute()
        for _ in range(2):
            p, t, s = next(b)
            q.enqueue(*to(p, t), stream_ids=to(s)[0])
    finally:
        q.close(drain=False)


@contextlib.contextmanager
def _degrade_warnings():
    """The degraded-mode warning goes out once a process for each site and error class."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "metrics_tpu.* degraded mode", RuntimeWarning)
        yield


def _torch(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _numpy(*xs):
    return tuple(np.asarray(x) for x in xs)


def _tree(spans):
    """The span set without ids and times: per span its name, its parent's name,
    its attribute keys and the names of the spans its links reach; sorted."""
    by_key = {(s["trace_id"], s["span_id"]): s for s in spans}
    out = []
    for s in spans:
        parent = by_key[(s["trace_id"], s["parent_span_id"])]["name"] if s["parent_span_id"] else ""
        attrs = s["attributes"]
        flags = tuple(attrs.get(k) for k in ("degraded", "dropped", "flow.sync", "flow.streams", "flow.fan_in"))
        links = tuple(sorted(by_key[(l["trace_id"], l["span_id"])]["name"] for l in s["links"]))
        out.append((s["name"], parent, tuple(sorted(attrs)), repr(flags), links))
    return sorted(out)


def test_span_trees_match_the_jax_package():
    batches = _batches(12)
    port, ref = _fleets(batches)
    _enable_both()
    _drive(IngestQueue, port, fault.FaultSchedule, _torch, batches)
    _drive(JIngestQueue, ref, JFaultSchedule, _numpy, batches)
    _wait_idle(obs)
    _wait_idle(jobs)
    port, ref = obs.flow.export_spans(), jobs.flow.export_spans()
    assert obs.flow.validate_spans(port) == len(port) > 0
    assert jobs.flow.validate_spans(port) == len(port)  # the JAX validator accepts the port's spans
    assert _tree(port) == _tree(ref)
    stats, jstats = obs.flow.stats(), jobs.flow.stats()
    assert stats["open"] == 0 and stats["device_errors"] == 0 and stats["watch_timeouts"] == 0
    assert {k: stats[k] for k in jstats} == jstats
    assert stats["dropped"] == 3 and stats["degraded"] == 2
    # the fan-in: one tick span linking the 3 flows of the first tick
    ticks = sorted(s["attributes"]["flow.fan_in"] for s in port if s["name"] == "tick")
    assert ticks == sorted(s["attributes"]["flow.fan_in"] for s in ref if s["name"] == "tick")
    assert 3 in ticks


def test_each_flows_stages_sum_to_its_end_to_end_latency():
    batches = _batches(12)
    port, _ = _fleets(batches)
    _enable_both()
    _drive(IngestQueue, port, fault.FaultSchedule, _torch, batches)
    _wait_idle(obs)
    recs = obs.flow.records()
    assert len(recs) == 12
    for r in recs:
        b = r.breakdown_us()
        assert set(b) == set(flow.STAGES)
        total = r.end_us() - r.t_enq
        assert sum(v for k, v in b.items() if k != "readback") == pytest.approx(total, rel=1e-9, abs=1e-6)
    completes = [e for e in obs.flight.events() if e["kind"] == "flow_complete"]
    assert len(completes) == 12
    for e in completes:
        assert sum(e[f"{k}_us"] for k in flow.STAGES if k != "readback") == pytest.approx(e["total_us"], abs=5e-3)


def test_synchronous_fused_flows_like_the_jax_package():
    obs.flow.enable(device=CPU)
    jobs.flow.enable()
    rng = np.random.default_rng(3)
    p, t = rng.random(16).astype(np.float32), rng.integers(0, 2, 16)
    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU)}, fused=True)
    jcoll = JMetricCollection({"acc": JBinaryAccuracy()}, fused=True)
    for _ in range(2):
        coll.update(*_torch(p, t))
        jcoll.update(p, t)
    _wait_idle(obs)
    _wait_idle(jobs)
    recs, jrecs = obs.flow.records(), jobs.flow.records()
    assert [(r.queue, r.sync, r.degraded, r.dispatched) for r in recs] == \
        [(r.queue, r.sync, r.degraded, r.dispatched) for r in jrecs]
    assert recs[0].queue == "fused/MetricCollection" and all(r.tick is not None for r in recs)
    assert recs[0].breakdown_us()["compile"] > 0.0 and recs[1].breakdown_us()["compile"] == 0.0
    assert _tree(obs.flow.export_spans()) == _tree(jobs.flow.export_spans())


def test_sampling_traces_one_in_n_like_the_jax_package():
    obs.flow.enable(sample_rate=2, device=CPU)
    jobs.flow.enable(sample_rate=2)
    p, t = np.asarray([0.1, 0.9, 0.8, 0.2], np.float32), np.asarray([0, 1, 1, 0])
    with IngestQueue(BinaryAccuracy(device=CPU), name="sampled", start=False) as q, \
            JIngestQueue(JBinaryAccuracy(), name="sampled", start=False) as jq:
        for _ in range(6):
            q.enqueue(*_torch(p, t))
            jq.enqueue(p, t)
        q.flush()
        jq.flush()
    _wait_idle(obs)
    st, jst = obs.flow.stats(), jobs.flow.stats()
    assert st["minted"] == jst["minted"] == 3 and st["sampled_out"] == jst["sampled_out"] == 3
    with pytest.raises(ValueError):
        obs.flow.enable(sample_rate=0, device=CPU)
    with pytest.raises(ValueError):
        obs.flow.enable(capacity=0, device=CPU)


def _flow_samples(page):
    return sorted(line for line in page.splitlines() if line.startswith("tm_flow_") and "latency" not in line)


def _flow_latency_labels(page):
    return sorted(line.split(" ")[0] for line in page.splitlines() if line.startswith("tm_flow_latency"))


def test_prom_flow_families_and_health_rollups_like_the_jax_package():
    batches = _batches(12)
    port, ref = _fleets(batches)
    _enable_both()
    _drive(IngestQueue, port, fault.FaultSchedule, _torch, batches)
    _drive(JIngestQueue, ref, JFaultSchedule, _numpy, batches)
    _wait_idle(obs)
    _wait_idle(jobs)
    page, jpage = prom.render(), jobs.prom.render()
    prom.validate_exposition(page)
    jobs.prom.validate_exposition(page)
    assert _flow_samples(page) == _flow_samples(jpage)
    assert _flow_latency_labels(page) == _flow_latency_labels(jpage)
    keys = {k for k in health.report()["latency_us"] if k.startswith("flow")}
    jkeys = {k for k in jobs.health.report()["latency_us"] if k.startswith("flow")}
    assert keys == jkeys
    assert {"flow/tenants", "flow_stage/device", "flow_stage/readback"} <= keys
    assert any(k.startswith("flow/tenants/") for k in keys)  # per tenant
    # the SLO that had nothing to read before flows: a budget of 0 ms is breached
    health.set_slo(p99_flow_latency_ms=0.0, action=lambda v: None)
    assert any(v["slo"] == "p99_flow_latency_ms" for v in health.check_slos())
    obs.flow.disable()
    assert "tm_flow_" not in prom.render()  # the families render only while a tracer is live


def test_checkpoint_names_the_flows_it_holds(tmp_path):
    obs.flight.enable(capacity=256)
    obs.flow.enable(device=CPU)
    m = BinaryAccuracy(device=CPU)
    p, t = _torch(np.asarray([0.1, 0.9, 0.8, 0.2], np.float32), np.asarray([0, 1, 1, 0]))
    with IngestQueue(m, name="ck", start=False) as q:
        q.enqueue(p, t)
        q.flush()
        _wait_idle(obs)
    ckpt.save_checkpoint(m, str(tmp_path / "ck"), blocking=True)
    evs = [e for e in obs.flight.events() if e["kind"] == "ckpt_flows"]
    assert len(evs) == 1 and evs[0]["count"] == 1 and evs[0]["flows"] == [obs.flow.records()[0].flow_id]
    ckpt.save_checkpoint(m, str(tmp_path / "ck2"), blocking=True)  # the drain is consumed
    assert len([e for e in obs.flight.events() if e["kind"] == "ckpt_flows"]) == 1


def test_dispatch_events_carry_the_covering_flow():
    obs.flight.enable(capacity=256)
    obs.flow.enable(device=CPU)
    p, t = _torch(np.asarray([0.1, 0.9], np.float32), np.asarray([0, 1]))
    with fault.FaultSchedule(fire_at={"ingest.tick": 0}), \
            IngestQueue(MeanSquaredError(device=CPU), name="deg", start=False) as q:
        q.enqueue(p, t)
        with _degrade_warnings():
            q.flush()
    _wait_idle(obs)
    (rec,) = obs.flow.records()
    assert rec.degraded
    dispatches = [e for e in obs.flight.events() if e["kind"] == "dispatch"]
    assert dispatches and dispatches[-1]["flow_id"] == rec.flow_id


# ---------------------------------------------------------- completion watcher


class _Event:
    """A stand-in for ``torch.cuda.Event``: incomplete for ``polls`` queries, then
    complete, or raising ``error`` at every query."""

    def __init__(self, polls=0, error=None):
        self.polls = polls
        self.error = error
        self.queries = 0

    def query(self):
        self.queries += 1
        if self.error is not None:
            raise self.error
        return self.queries > self.polls


def _minted(trc, n, queue="w"):
    flows = [trc.mint(queue, 1) for _ in range(n)]
    trc.stamp_drain(flows)
    trc.stamp_launch(flows)
    return flows


def test_watcher_stamps_a_late_completion():
    obs.flight.enable(capacity=64)
    trc = obs.flow.enable(device=CPU)
    flows = _minted(trc, 2)
    event = _Event(polls=3)
    trc.dispatch(flows, event)
    _wait_idle(obs)
    assert event.queries >= 4 and all(fl.closed and not fl.degraded for fl in flows)
    assert flows[0].tick == flows[1].tick and flows[0].t_device >= flows[0].t_dispatch
    assert obs.flow.stats()["completed"] == 2 and obs.flow.stats()["open"] == 0


def test_watcher_counts_a_device_error_and_closes_degraded():
    obs.flight.enable(capacity=64)
    trc = obs.flow.enable(device=CPU)
    inline = _minted(trc, 1)
    trc.dispatch(inline, _Event(error=RuntimeError("CUDA error: an illegal memory access was encountered")))
    late = _minted(trc, 2)
    event = _Event(polls=2)
    trc.dispatch(late, event)
    event.error = RuntimeError("CUDA error: unspecified launch failure")
    _wait_idle(obs)
    st = obs.flow.stats()
    assert st["device_errors"] == 2 and st["degraded"] == 3 and st["open"] == 0
    assert all(fl.degraded and fl.closed for fl in inline + late)
    assert registry.REGISTRY.get("flow", "device_errors") == 2
    faults = [e for e in obs.flight.events() if e["kind"] == "flow_fault"]
    assert len(faults) == 2 and "illegal memory access" in faults[0]["error"]


def test_watcher_deadline_closes_a_tick_that_never_completes():
    trc = obs.flow.enable(device=CPU)
    trc.watch_timeout_s = 0.05
    flows = _minted(trc, 1)
    trc.dispatch(flows, _Event(polls=10**9))
    _wait_idle(obs)
    assert obs.flow.stats()["watch_timeouts"] == 1 and flows[0].degraded and flows[0].closed


def test_shutdown_joins_the_watcher():
    trc = obs.flow.enable(device=CPU)
    watcher = trc._watcher
    obs.flow.disable()
    watcher.join(WAIT_S)
    assert not watcher.is_alive()


# ------------------------------------------------------------------- the gate


def _boom(*_a, **_k):
    raise AssertionError("a tracing, retrace or scope surface was reached with its gate off")


def _arm_booms(monkeypatch, with_obs_surfaces: bool):
    for name in ("mint", "open_sync", "close_sync", "stamp_drain", "stamp_launch", "add_compile", "dispatch",
                 "close_degraded", "close_dropped", "close_now", "note_readback", "drain_for_ckpt",
                 "attribute_streams"):
        monkeypatch.setattr(flow.FlowTracer, name, _boom)
    monkeypatch.setattr(flow, "host_stream_ids", _boom)
    monkeypatch.setattr(flow, "current", _boom)
    monkeypatch.setattr(flow, "device_done_event", _boom)
    if with_obs_surfaces:
        monkeypatch.setattr(recompile, "check_update", _boom)
        for name in ("annotate", "update_scope", "compute_scope", "forward_scope", "sync_scope"):
            monkeypatch.setattr(scopes, name, _boom)


def _drive_every_path():
    p, t = _torch(np.asarray([0.1, 0.9, 0.8, 0.2], np.float32), np.asarray([0, 1, 1, 0]))
    m = BinaryAccuracy(device=CPU)
    m.update(p, t)
    m.compute()
    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU)}, fused=True)
    coll.update(p, t)
    coll.forward(p, t)
    coll.compute()
    fm = MeanSquaredError(fleet_size=4, device=CPU)
    fm.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 3.0]), stream_ids=torch.tensor([0, 1]))
    with IngestQueue(BinaryAccuracy(device=CPU), name="off", start=False) as q:
        q.enqueue(p, t)
        q.flush()
        q.compute()


def test_gate_off_reaches_no_flow_retrace_or_scope_surface(monkeypatch):
    _arm_booms(monkeypatch, with_obs_surfaces=True)
    _drive_every_path()
    assert registry.REGISTRY.snapshot() == {}


def test_obs_on_without_a_tracer_reaches_no_flow_surface(monkeypatch):
    obs.enable()
    obs.flight.enable(capacity=64)
    _arm_booms(monkeypatch, with_obs_surfaces=False)
    _drive_every_path()
    assert obs.flow.stats() == {} and obs.flow.records() == []
    assert registry.REGISTRY.get("BinaryAccuracy", "updates") >= 1
