"""metrics_tpu_torch.serve.excache on the CPU: the warm manifest and prewarm in their
torch meaning, held against the JAX package's where the two share a contract.

- The manifest round-trips through ``save_manifest``/``load_manifest`` and the
  checkpoint manager writes it beside a checkpoint while recording is on.
- ``stable_key_digest`` of a queue's chain key is the same in two processes with
  different ``PYTHONHASHSEED`` (and no ``id()`` enters it).
- Each degradation warns once and skips: schema drift, a stale stamp, a JAX
  manifest, an entry of an engine the port keeps no cache for, and an
  ``excache.prewarm`` fault (whose entry then captures lazily, bit-equal).
- An input the manifest cannot encode drops the entry (``unrecordable``), never the
  update.
- Prewarm followed by requests leaves the state bit-equal to a cold run, and the
  first request after prewarm builds no step.

On the card a prewarmed step is a CUDA-graph capture; that is held in
``tests/test_torch_kernels.py``.
"""
import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.core.fused import canonical_collection as jax_canonical
from metrics_tpu.serve import excache as jexcache
from metrics_tpu_torch import _build, ckpt, fault, obs
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.core import fused as _fused
from metrics_tpu_torch.core.fused import canonical_collection
from metrics_tpu_torch.obs import flight, health, prom, registry, series
from metrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError
from metrics_tpu_torch.serve import IngestQueue, active_queues, excache
from metrics_tpu_torch.serve import server as tserver
from metrics_tpu_torch.utils.exceptions import MetricsUserWarning
from tests.torch_deadline import deadline  # noqa: F401
from tests.torch_globals import restores_globals  # noqa: F401

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    excache.disable_recording()
    excache.clear_manifest()
    excache.clear_stats()
    excache.disable_persistent_cache()
    excache._LAST_PREWARM = None
    _fused._DEGRADE_WARNED.clear()


@pytest.fixture(autouse=True)
def _leaves_nothing_behind(restores_globals):
    _reset()
    yield
    _reset()
    jexcache.disable_recording()
    jexcache.clear_manifest()
    ckpt.wait_for_all_saves(timeout_s=60)
    assert {
        "server": tserver.active_servers(), "queue": active_queues(), "prom": prom.server_active(),
        "flight": flight.active(), "health": health.active(), "series": series.active(),
        "fault": fault.current(), "gate": registry._ENABLED, "recording": excache.recording(),
    } == {"server": [], "queue": [], "prom": False, "flight": False, "health": False, "series": False,
          "fault": None, "gate": False, "recording": False}
    _reset()


def _batches(n, rows=32, seed=7):
    r = np.random.RandomState(seed)
    return [(r.rand(rows).astype(np.float32), r.randint(0, 2, rows).astype(np.int32)) for _ in range(n)]


def _leaves(v):
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _leaves(v[k])]
    return [v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)]


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True) for x, y in zip(la, lb))


def _record_queue(batches, groups=(3, 1)):
    """A recorded run: ticks of ``groups`` batches, then the manifest."""
    excache.enable_recording(clear=True)
    coll = canonical_collection(True, device=CPU)
    with IngestQueue(coll, start=False) as q:
        it = iter(batches)
        for size in groups:
            for _ in range(size):
                q.enqueue(*next(it))
            q.flush()
    excache.disable_recording()
    return excache.manifest_payload(), coll


# ------------------------------------------------------------------ manifest


def test_manifest_round_trip_and_ckpt_rider(tmp_path):
    payload, _ = _record_queue(_batches(4))
    assert payload["schema"] == excache.SCHEMA_VERSION and payload["torch_version"] == torch.__version__
    assert [(e["engine"], e["scan"], e["count"]) for e in payload["entries"]] == [("ingest", True, 3),
                                                                                  ("ingest", False, 1)]
    path = excache.save_manifest(str(tmp_path / excache.MANIFEST_NAME))
    assert excache.load_manifest(path) == json.loads(json.dumps(payload))
    inputs = (torch.zeros(4, dtype=torch.float32), np.zeros((2, 3), np.int32), 3, "x", None, [1.5, True])
    kwargs = {"b": torch.zeros(1, dtype=torch.bool), "a": 2}
    enc = json.loads(json.dumps(excache._encode_inputs(inputs, kwargs)))
    args, kw = excache._decode_inputs(enc, torch.device(CPU))
    assert list(kw) == ["b", "a"] and kw["a"] == 2 and kw["b"].dtype == torch.bool
    assert args[1].dtype == torch.int32 and args[1].shape == (2, 3) and args[2:] == (3, "x", None, [1.5, True])
    m = MeanSquaredError(device=CPU)
    m.update(torch.ones(3), torch.zeros(3))
    step_dir = m.save_checkpoint(str(tmp_path / "plain")).result(timeout=60)
    assert not os.path.exists(os.path.join(os.path.dirname(step_dir), excache.MANIFEST_NAME))
    excache.enable_recording()
    step_dir = m.save_checkpoint(str(tmp_path / "rec")).result(timeout=60)
    assert os.path.isfile(os.path.join(os.path.dirname(step_dir), excache.MANIFEST_NAME))


_DIGEST_CHILD = r"""
import numpy as np
from metrics_tpu_torch.core.fused import canonical_collection
from metrics_tpu_torch.serve import IngestQueue, excache
excache.enable_recording()
r = np.random.RandomState(0)
with IngestQueue(canonical_collection(True, device="cpu"), start=False) as q:
    for n in (2, 1):
        for _ in range(n):
            q.enqueue(r.rand(16).astype(np.float32), r.randint(0, 2, 16).astype(np.int32))
        q.flush()
print(",".join(e["key_digest"] for e in excache.manifest_entries()))
"""


def test_key_digest_is_equal_across_hash_seeds():
    out = []
    for seed in ("1", "4242"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", _DIGEST_CHILD], capture_output=True, text=True, env=env,
                              cwd=REPO, timeout=240)
        assert proc.returncode == 0, proc.stderr
        out.append(proc.stdout.strip().splitlines()[-1])
    assert out[0] == out[1] and len(out[0].split(",")) == 2
    assert _fused._stable_repr(("id", 12345)) == "id:*"


# ---------------------------------------------------------------- prewarm


def _served(batches, manifest=None, prewarm_twice=False):
    """Requests of one batch each after an optional prewarm: the state and the step
    stats."""
    coll = canonical_collection(True, device=CPU)
    with IngestQueue(coll, start=False) as q:
        report = None
        if manifest is not None:
            report = excache.prewarm(q, manifest)
            if prewarm_twice:
                assert excache.prewarm(q, manifest)["compiled"] == 0
        misses = q.step_stats.get("cache_misses", 0)
        q.enqueue(*batches[0])
        q.flush()
        first = q.step_stats["cache_misses"] - misses
        for b in batches[1:]:
            q.enqueue(*b)
        q.flush()
        stats = dict(q.step_stats)
    return coll.compute(), report, first, stats


def test_prewarm_then_requests_is_bit_equal_to_a_cold_run(tmp_path):
    batches = _batches(6, seed=3)
    manifest, _ = _record_queue(_batches(4))
    excache.enable_persistent_cache(str(tmp_path / "kernels"))
    try:
        cold, _, cold_first, _ = _served(batches)
        excache.clear_stats()
        warm, report, warm_first, stats = _served(batches, manifest, prewarm_twice=True)
        assert report == dict(report, entries=2, compiled=2, skipped=0, failed=0)
        assert cold_first == 1 and warm_first == 0  # the first request builds no step
        assert stats["cache_misses"] == 1  # the 5-batch tick: lazily, as without prewarm
        assert excache.stats()["compiles"] == 3 and excache.stats()["prewarmed"] == 2
        assert _bitwise(cold, warm)
        m = MeanSquaredError(device=CPU)
        assert m.state_report()["warmup"]["compiled"] == 0  # the second prewarm's report
    finally:
        excache.disable_persistent_cache()


def test_fused_prewarm_first_update_builds_no_step():
    batches = _batches(3, seed=5)
    excache.enable_recording()
    rec = canonical_collection(True, device=CPU)
    rec.update(*batches[0])
    entries = excache.manifest_entries()
    assert [e["engine"] for e in entries] == ["fused"]
    manifest = excache.manifest_payload()
    excache.disable_recording()
    warm, cold = canonical_collection(True, device=CPU), canonical_collection(True, device=CPU)
    assert excache.prewarm(warm, manifest)["compiled"] == 1
    engine = _fused.engine_for(warm)
    for b in batches:
        warm.update(*b)
        cold.update(*b)
    assert engine.stats["cache_misses"] == 0 and engine.stats["cache_hits"] == 3
    assert _bitwise(warm.compute(), cold.compute())


def _jax_manifest():
    jexcache.enable_recording(clear=True)
    coll = jax_canonical(True)
    p, t = _batches(1)[0]
    coll.update(jnp.asarray(p), jnp.asarray(t))
    payload = jexcache.manifest_payload()
    jexcache.disable_recording()
    return payload


@pytest.mark.parametrize("case", ["schema", "stale_stamp", "jax_manifest", "rank_engine", "unreadable"])
def test_each_degradation_warns_once_and_skips(case, tmp_path):
    manifest, _ = _record_queue(_batches(4))
    if case == "schema":
        manifest = dict(manifest, schema=99)
    elif case == "stale_stamp":
        manifest = dict(manifest, torch_version="0.0.0")
    elif case == "jax_manifest":
        manifest = _jax_manifest()
        assert manifest["entries"] and "jax_version" in manifest
    elif case == "rank_engine":
        manifest = dict(manifest, entries=[{"engine": "rank", "op": "binary_auroc_exact", "inputs": []}])
    else:
        manifest = str(tmp_path / "missing.json")
    coll = canonical_collection(True, device=CPU)
    with IngestQueue(coll, start=False) as q:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            report = excache.prewarm(q, manifest)
        ours = [w for w in seen if issubclass(w.category, MetricsUserWarning)]
        assert len(ours) == 1 and "excache.prewarm" in str(ours[0].message), [str(w.message) for w in seen]
        assert report["compiled"] == 0 and report["failed"] == 0
        assert not q._steps.steps  # nothing captured ahead
        q.enqueue(*_batches(1)[0])
        q.flush()
        assert q.step_stats["cache_misses"] == 1  # lazily, at first use


def test_injected_prewarm_fault_skips_one_entry_and_it_captures_lazily():
    batches = _batches(4, seed=9)
    manifest, _ = _record_queue(_batches(4))
    cold, _, _, _ = _served(batches)
    coll = canonical_collection(True, device=CPU)
    with IngestQueue(coll, start=False) as q:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with fault.FaultSchedule(fire_at={"excache.prewarm": 1}) as sched:
                report = excache.prewarm(q, manifest)
        assert [w for w in seen if "excache.prewarm failed" in str(w.message)]
        assert report == dict(report, entries=2, compiled=1, failed=1) and len(sched.fired) == 1
        assert excache.stats()["prewarm_failures"] == 1
        misses = q.step_stats.get("cache_misses", 0)
        q.enqueue(*batches[0])
        q.flush()
        assert q.step_stats["cache_misses"] == misses + 1  # the faulted 1-batch entry: lazily
        for b in batches[1:]:
            q.enqueue(*b)
        q.flush()
    assert _bitwise(coll.compute(), cold)


def test_unrecordable_input_drops_the_entry_not_the_update():
    class Opaque:
        pass

    excache.enable_recording()
    coll = MetricCollection({"mse": MeanSquaredError(device=CPU), "mae": MeanAbsoluteError(device=CPU)}, fused=True)
    coll.update(torch.ones(4), torch.zeros(4))
    with IngestQueue(coll, start=False) as q:
        q.enqueue(torch.ones(4), torch.zeros(4), opaque=Opaque())
        q.flush()
    assert excache.stats()["unrecordable"] == 1
    assert [e["engine"] for e in excache.manifest_entries()] == ["fused"]
    assert coll["mse"]._update_count == 2


def test_persistent_kernel_directory_counts_disk_hits_without_nvcc(tmp_path):
    cache = str(tmp_path / "kernels")
    excache.enable_persistent_cache(cache)
    try:
        assert excache.cache_dir() == cache and str(_build.library_path("histogram")).startswith(cache)
        _build.library_path("histogram").write_bytes(b"")  # found built: no nvcc runs
        assert _build.build(["histogram"]) == [_build.library_path("histogram")]
        assert excache.stats()["disk_hits"] == 1 and excache.stats()["compiles"] == 0
    finally:
        excache.disable_persistent_cache()
    assert _build.BUILD_DIR == excache._DEFAULT_BUILD_DIR and excache.cache_dir() is None


@pytest.mark.parametrize("engine", ["fused", "ingest"])
def test_compiles_count_only_while_the_directory_is_set(tmp_path, engine):
    """``compiles`` counts the steps the step caches build (and ``nvcc`` runs) while the
    persistent directory is set: nothing before it, nothing while it is off again, and
    what it counted survives the disable; ``clear_stats`` starts again from zero."""
    excache.clear_stats()

    def new_key(rows):  # a batch count or shape no step cache has seen: one step built
        if engine == "fused":
            canonical_collection(True, device=CPU).update(torch.rand(rows), torch.randint(0, 2, (rows,)))
        else:
            with IngestQueue(MeanSquaredError(device=CPU), start=False) as q:
                q.enqueue(torch.rand(rows), torch.rand(rows))
                q.flush()

    new_key(5)
    assert excache.stats()["compiles"] == 0
    excache.enable_persistent_cache(str(tmp_path / "kernels"))
    try:
        new_key(6)
        assert excache.stats()["compiles"] == 1
        excache.disable_persistent_cache()
        new_key(7)
        assert excache.stats()["compiles"] == 1 and excache.stats()["disk_hits"] == 0
        excache.enable_persistent_cache(str(tmp_path / "kernels"))
        new_key(8)
        assert excache.stats()["compiles"] == 2
        excache.clear_stats()
        assert excache.stats()["compiles"] == 0
        new_key(9)
        assert excache.stats()["compiles"] == 1
    finally:
        excache.disable_persistent_cache()
        excache.clear_stats()


def test_excache_families_and_the_cold_compile_slo(tmp_path):
    obs.enable()
    try:
        page = prom.render()
        assert "tm_excache" not in page  # imported but not configured: nothing
        excache.enable_persistent_cache(str(tmp_path / "kernels"))
        _record_queue(_batches(4))
        page = prom.render()
        assert prom.validate_exposition(page) > 0
        assert "tm_excache_persistent_enabled 1" in page and "tm_excache_compiles_total 2" in page
        assert "tm_excache_manifest_entries 2" in page
        health.enable(device=CPU)
        health.set_slo(max_cold_compiles=0, action=lambda v: None)
        (violation,) = health.check_slos()
        assert violation["slo"] == "max_cold_compiles" and violation["measured"] == 2
    finally:
        health.disable()
        excache.disable_persistent_cache()
        obs.disable()
