"""metrics_tpu_torch.fault and ``Metric(nan_policy=...)`` against the JAX package, on the CPU.

- Schedules: the closed ``SITES`` tuple is the JAX package's; explicit plans fire
  exactly their occurrences, seeded ones the same pattern for the same seed in both
  packages, independent of other sites; ``max_fires``; thread-safe counts; nesting.
- ``poison_inputs``: the rows a schedule poisons are the JAX package's rows for the
  same seed and occurrence; ints, scalars and strings pass through.
- ``nan_policy``: counts of NaN/Inf rows equal the JAX package's; warn, raise (the
  state, count and caches untouched) and count; skipped inside a traced step; a
  policy makes a group ineligible for fusion, yet the fused collection quarantines.
- The degradation ladder: a ``fused.compile`` or ``fused.launch`` fault demotes the
  key to the eager path, bit-equal to eager, one warning a class; a seeded schedule
  over 50 steps; the checkpoint sites retried to success, exhausted retries typed,
  the fallback ladder walking back past a corrupt step.

Every test leaves no schedule, enabled registry or ingest queue behind.
"""
import os
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
from metrics_tpu import fault as jfault
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.core import fused as _fused
from metrics_tpu_torch.core.fused import canonical_collection, engine_for, fusion_fallback_reason
from metrics_tpu_torch.fault import PoisonedInputError
from metrics_tpu_torch.obs import registry
from metrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError
from metrics_tpu_torch.serve import active_queues
from metrics_tpu_torch.utils.checks import tracing
from metrics_tpu_torch.utils.exceptions import MetricsUserWarning

CPU = "cpu"
_CLEAN_P, _CLEAN_T = np.array([1.0, 2.0, 3.0], np.float32), np.array([1.0, 3.0, 5.0], np.float32)
_BAD_P, _BAD_T = np.array([1.0, np.nan, 3.0], np.float32), np.array([1.0, 3.0, np.inf], np.float32)


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    _fused._DEGRADE_WARNED.clear()
    yield
    _fused._DEGRADE_WARNED.clear()
    ckpt.wait_for_all_saves()
    assert fault.current() is None
    assert registry._ENABLED is False
    assert active_queues() == []


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


# --------------------------------------------------------------- schedules


def test_sites_are_the_jax_packages():
    assert fault.SITES == jfault.SITES and len(fault.SITES) == 14


def test_no_schedule_is_inert_and_context_arms_and_disarms():
    assert not fault.active() and fault.current() is None
    fault.fire("ckpt.write")  # nothing armed: no-op
    outer = fault.FaultSchedule(fire_at={"ckpt.write": 0})
    with outer:
        assert fault.current() is outer
        with fault.FaultSchedule() as inner:
            assert fault.current() is inner
        assert fault.current() is outer
        with pytest.raises(fault.InjectedFaultError) as exc:
            fault.fire("ckpt.write", step=3)
    assert fault.current() is None
    assert isinstance(exc.value, OSError) and exc.value.site == "ckpt.write" and exc.value.occurrence == 0
    assert outer.fired == [{"site": "ckpt.write", "occurrence": 0, "step": 3}]
    with pytest.raises(RuntimeError):
        with fault.FaultSchedule():
            raise RuntimeError("boom")
    assert fault.current() is None


def test_explicit_plans_and_validation():
    with fault.FaultSchedule(fire_at={"fused.launch": (0, 2), "ckpt.rename": 1}) as sched:
        for _ in range(4):
            for site in ("fused.launch", "ckpt.rename"):
                try:
                    fault.fire(site)
                except fault.InjectedFaultError:
                    pass
    assert [(e["site"], e["occurrence"]) for e in sched.fired] == [
        ("fused.launch", 0), ("ckpt.rename", 1), ("fused.launch", 2)
    ]
    with pytest.raises(ValueError, match="unknown fault site"):
        fault.FaultSchedule(fire_at={"nope": 0})
    with pytest.raises(ValueError, match="rate"):
        fault.FaultSchedule(rate=1.5, sites=("ckpt.write",))
    with pytest.raises(ValueError, match="requires sites"):
        fault.FaultSchedule(rate=0.5)


def _pattern(module, seed, sites, calls=40):
    sched = module.FaultSchedule(seed=seed, sites=sites, rate=0.3)
    for _ in range(calls):
        for site in sites:
            sched._on_call(site, {})
    return [(e["site"], e["occurrence"]) for e in sched.fired]


def test_seeded_pattern_equals_the_jax_packages_and_ignores_interleaving():
    sites = ("ckpt.write", "fused.launch")
    assert _pattern(fault, 11, sites) == _pattern(jfault, 11, sites)
    assert _pattern(fault, 11, sites) and _pattern(fault, 1, sites) != _pattern(fault, 2, sites)
    alone = [o for s, o in _pattern(fault, 5, ("ckpt.write",)) if s == "ckpt.write"]
    mixed = [o for s, o in _pattern(fault, 5, ("agg.read", "ckpt.write")) if s == "ckpt.write"]
    assert alone == mixed


def test_max_fires_and_thread_safe_counts():
    sched = fault.FaultSchedule(fire_at={"ckpt.write": tuple(range(10))}, max_fires=3)
    for _ in range(10):
        sched._on_call("ckpt.write", {})
    assert len(sched.fired) == 3
    busy = fault.FaultSchedule(fire_at={"ckpt.fsync": 10**6})
    threads = [threading.Thread(target=lambda: [busy._on_call("ckpt.fsync", {}) for _ in range(500)]) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert busy.counts["ckpt.fsync"] == 2000


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_poisoned_rows_are_the_jax_packages(seed):
    x = np.zeros((16, 2), np.float32)
    y = np.arange(40, dtype=np.float32)
    with fault.FaultSchedule(seed=seed, fire_at={"input.poison": (0, 1)}) as sched:
        fault.poison_inputs((torch.zeros(3),), {}, metric="M")  # occurrence 0
        (px, ints, scalar), kw = fault.poison_inputs(
            (torch.from_numpy(x), torch.arange(8), torch.tensor(1.0)), {"y": torch.from_numpy(y), "s": "text"}, metric="M"
        )
    with jfault.FaultSchedule(seed=seed, fire_at={"input.poison": (0, 1)}) as jsched:
        jfault.poison_inputs((jnp.zeros(3),), {}, metric="M")
        (jx, _, _), jkw = jfault.poison_inputs(
            (jnp.asarray(x), jnp.arange(8), jnp.float32(1.0)), {"y": jnp.asarray(y), "s": "text"}, metric="M"
        )
    assert np.array_equal(np.isnan(px.numpy()), np.isnan(np.asarray(jx)))
    assert np.array_equal(np.isnan(kw["y"].numpy()), np.isnan(np.asarray(jkw["y"])))
    assert int(np.isnan(px.numpy()).any(-1).sum()) == 2 and int(np.isnan(kw["y"].numpy()).sum()) == 5
    assert ints.dtype == torch.int64 and not torch.isnan(scalar) and kw["s"] == "text"
    assert x.sum() == 0  # the input itself is not written
    assert sched.fired[1]["rows"] == jsched.fired[1]["rows"] == 7


# --------------------------------------------------------------- nan_policy


def test_nan_policy_values_and_default():
    m = MeanSquaredError(device=CPU)
    assert m.nan_policy is None
    m.update(*_t(_BAD_P, _BAD_T))
    assert not torch.isfinite(m.compute())
    with pytest.raises(ValueError, match="nan_policy") as exc:
        MeanSquaredError(nan_policy="drop", device=CPU)
    with pytest.raises(ValueError) as jexc:
        metrics_tpu.regression.MeanSquaredError(nan_policy="drop")
    assert str(exc.value) == str(jexc.value)


def test_count_policy_tallies_the_jax_packages_rows():
    with obs.observe(clear=True) as reg:
        m = MeanSquaredError(nan_policy="count", device=CPU)
        m.update(*_t(_BAD_P, _BAD_T))
        m.update(*_t(_CLEAN_P, _CLEAN_T))
        rows = reg.get("MeanSquaredError", "nonfinite_rows")
    obs.REGISTRY.clear()
    from metrics_tpu import obs as jobs

    with jobs.observe(clear=True) as jreg:
        jm = metrics_tpu.regression.MeanSquaredError(nan_policy="count")
        jm.update(jnp.asarray(_BAD_P), jnp.asarray(_BAD_T))
        jrows = jreg.get("MeanSquaredError", "nonfinite_rows")
    jobs.REGISTRY.clear()
    assert rows == jrows == 2
    assert m._update_count == 2


def test_count_without_registry_is_silent_and_warn_warns():
    m = MeanSquaredError(nan_policy="count", device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.update(*_t(_BAD_P, _BAD_T))
    w = MeanSquaredError(nan_policy="warn", device=CPU)
    with pytest.warns(MetricsUserWarning, match="2 update input row"):
        w.update(*_t(_BAD_P, _BAD_T))
    assert w._update_count == 1


def test_raise_policy_rejects_the_batch_and_leaves_everything():
    m = MeanSquaredError(nan_policy="raise", device=CPU)
    m.update(*_t(_CLEAN_P, _CLEAN_T))
    before = m.compute().clone()
    states = {k: v.clone() for k, v in m.metric_state.items()}
    with pytest.raises(PoisonedInputError) as exc:
        m.update(*_t(_BAD_P, _BAD_T))
    assert (exc.value.rows, exc.value.metric) == (2, "MeanSquaredError")
    assert m._update_count == 1 and m._computed is not None
    assert all(torch.equal(v, states[k]) for k, v in m.metric_state.items())
    assert torch.equal(m.compute(), before)
    with pytest.raises(PoisonedInputError):  # a 0-d float input is one row
        m.update(torch.tensor(float("nan")), torch.tensor(1.0))
    MeanAbsoluteError(nan_policy="raise", device=CPU).update(torch.arange(3), torch.arange(3))  # ints: no check


def test_traced_step_skips_the_quarantine():
    m = MeanSquaredError(nan_policy="raise", device=CPU)
    with tracing():
        m.local_update(m.init_state(), *_t(_BAD_P, _BAD_T))  # no host read, no raise
    out = torch.func.vmap(lambda p, t: m.local_update(m.init_state(), p, t)["sum_squared_error"])(
        *_t(np.stack([_BAD_P] * 2), np.stack([_BAD_T] * 2))
    )
    assert out.shape[0] == 2


def test_nan_policy_is_not_fused_but_quarantines_in_a_fused_collection():
    m = MeanSquaredError(nan_policy="count", device=CPU)
    reason = fusion_fallback_reason(m, [m])
    assert reason is not None and "nan_policy" in reason
    assert fusion_fallback_reason(MeanSquaredError(device=CPU), [MeanSquaredError(device=CPU)]) is None
    with obs.observe(clear=True) as reg:
        c = MetricCollection({"mse": MeanSquaredError(nan_policy="count", device=CPU),
                              "mae": MeanAbsoluteError(device=CPU)}, fused=True)
        c.update(*_t(_BAD_P, _BAD_T))
        assert reg.get("MeanSquaredError", "nonfinite_rows") == 2
    obs.REGISTRY.clear()
    assert engine_for(c).stats["fallback_groups"] == 1


def test_injected_poison_is_caught_by_the_quarantine():
    m = MeanSquaredError(nan_policy="raise", device=CPU)
    with fault.FaultSchedule(fire_at={"input.poison": 0}) as sched:
        with pytest.raises(PoisonedInputError):
            m.update(torch.ones(16), torch.ones(16))
    assert sched.fired[0]["rows"] == 4 and m._update_count == 0
    with obs.observe(clear=True) as reg:
        c = MeanSquaredError(nan_policy="count", device=CPU)
        with fault.FaultSchedule(fire_at={"input.poison": 0}):
            c.update(torch.ones(16), torch.ones(16))
        assert reg.get("MeanSquaredError", "nonfinite_rows") >= 2
    obs.REGISTRY.clear()


# -------------------------------------------------------------- degradation


_P, _T = np.array([1.0, 2.0, 3.0, 4.0], np.float32), np.array([1.0, 3.0, 5.0, 7.0], np.float32)


def _collection():
    return MetricCollection({"mse": MeanSquaredError(device=CPU), "mae": MeanAbsoluteError(device=CPU)}, fused=True)


def _run(c, steps=2):
    for _ in range(steps):
        c.update(*_t(_P, _T))
    return c.compute()


@pytest.mark.parametrize("site", ["fused.compile", "fused.launch"])
def test_fused_fault_degrades_bit_equal_with_one_warning(site):
    want = _run(_collection())
    c = _collection()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with fault.FaultSchedule(fire_at={site: 0}) as sched:
            c.update(*_t(_P, _T))
        c.update(*_t(_P, _T))
    got = c.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert [e["site"] for e in sched.fired] == [site]
    assert engine_for(c).stats["degrades"] == 1
    degraded = [w for w in caught if "degraded mode" in str(w.message)]
    assert len(degraded) == 1 and site in str(degraded[0].message)


def test_launch_fault_mid_run_keeps_the_state_and_the_key_stays_eager():
    want = _run(_collection(), steps=3)
    c = _collection()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fault.FaultSchedule(fire_at={"fused.launch": 1}):
            got = _run(c, steps=3)
    assert all(torch.equal(got[k], want[k]) for k in want)
    launches = engine_for(c).stats["launches"]
    c.update(*_t(_P, _T))
    assert engine_for(c).stats["launches"] == launches  # the broken key goes straight to eager


def test_seeded_launch_schedule_over_50_steps_is_bit_equal_to_eager():
    r = np.random.RandomState(7)
    batches = [(r.rand(64).astype(np.float32), r.randint(0, 2, 64).astype(np.int32)) for _ in range(50)]
    fused, eager = canonical_collection(True, device=CPU), canonical_collection(False, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fault.FaultSchedule(seed=7, sites=("fused.launch",), rate=0.25) as sched:
            for p, t in batches:
                fused.update(*_t(p, t))
                eager.update(*_t(p, t))
    got, want = fused.compute(), eager.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert sched.fired and engine_for(fused).stats["degrades"] > 0


def test_no_schedule_no_site_calls(monkeypatch):
    from metrics_tpu_torch.fault import inject

    calls = []
    monkeypatch.setattr(inject, "fire", lambda *a, **k: calls.append(a))
    _run(_collection())
    assert calls == []


# ------------------------------------------------------------- checkpoint IO


def _mse():
    m = MeanSquaredError(device=CPU)
    m.update(*_t(_P, _T))
    return m


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.fsync", "ckpt.rename"])
def test_single_io_fault_is_retried_to_success(tmp_path, site):
    m = _mse()
    with obs.observe(clear=True) as reg:
        with fault.FaultSchedule(fire_at={site: 0}) as sched:
            handle = m.save_checkpoint(str(tmp_path), step=0, retry_backoff_s=0.001)
        assert handle.committed and sched.fired[0]["site"] == site
        assert reg.get("ckpt", "save_retries") == 1
    obs.REGISTRY.clear()
    fresh = MeanSquaredError(device=CPU)
    assert fresh.restore_checkpoint(str(tmp_path)) == 0
    assert torch.equal(fresh.compute(), m.compute())


def test_exhausted_retries_raise_typed_and_async_through_the_handle(tmp_path):
    m = _mse()
    with fault.FaultSchedule(fire_at={"ckpt.write": (0, 1, 2)}):
        with pytest.raises(fault.InjectedFaultError):
            m.save_checkpoint(str(tmp_path), step=0, retry_backoff_s=0.001)
    assert ckpt.all_steps(str(tmp_path)) == []
    with fault.FaultSchedule(fire_at={"ckpt.write": (0, 1, 2)}):
        handle = m.save_checkpoint(str(tmp_path), step=1, blocking=False, retry_backoff_s=0.001)
        with pytest.raises(fault.InjectedFaultError):
            handle.result(timeout=60)
    with fault.FaultSchedule(fire_at={"ckpt.write": 0}):
        with pytest.raises(fault.InjectedFaultError):
            m.save_checkpoint(str(tmp_path), step=2, retries=1)


def test_wait_for_all_saves_timeout_lists_stuck_steps(tmp_path, monkeypatch):
    import time

    from metrics_tpu_torch.ckpt import manager

    real = manager._serializer.write_payload
    release = time.monotonic() + 0.4

    def slow(path, entries):
        while time.monotonic() < release:
            time.sleep(0.01)
        return real(path, entries)

    monkeypatch.setattr(manager._serializer, "write_payload", slow)
    _mse().save_checkpoint(str(tmp_path), step=7, blocking=False)
    with pytest.raises(ckpt.CheckpointTimeoutError) as exc:
        ckpt.wait_for_all_saves(timeout_s=0.05)
    assert exc.value.steps == (7,)
    ckpt.wait_for_all_saves()
    assert MeanSquaredError(device=CPU).restore_checkpoint(str(tmp_path)) == 7


def test_fallback_steps_walk_back_past_a_corrupt_step(tmp_path):
    d = str(tmp_path)
    m = _mse()
    m.save_checkpoint(d, step=0)
    want = m.compute().clone()
    m.update(*_t(_P * 2, _T))
    m.save_checkpoint(d, step=1)
    with open(os.path.join(d, "step_0000000001", "arrays-h0000.bin"), "r+b") as fh:
        fh.write(b"\x00garbage")
    live = MeanSquaredError(device=CPU)
    with pytest.raises(ckpt.CorruptCheckpointError):
        live.restore_checkpoint(d)
    assert live._update_count == 0  # a failed attempt leaves the metric as it was
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert live.restore_checkpoint(d, fallback_steps=1) == 0
    assert torch.equal(live.compute(), want)
    with pytest.raises(ckpt.CorruptCheckpointError):
        MeanSquaredError(device=CPU).restore_checkpoint(d, step=1, fallback_steps=0)
