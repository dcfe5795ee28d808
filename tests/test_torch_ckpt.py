"""metrics_tpu_torch.ckpt against metrics_tpu.ckpt, on the CPU.

Seeded numpy batches go through a JAX metric and its port (``device="cpu"``):

- save, a new object, restore, continue: each package's restored compute is
  bit-equal to its own uninterrupted run, and the two packages agree within the
  tolerance of the port's existing tests (MulticlassAccuracy and the confusion
  matrix on the histogram path, BinaryAUROC with ``cat_capacity`` and with list
  states, QuantileSketch and DistinctCount, the five-group collection fused and
  eager, a fleet sliced with ``stream=i``, BootStrapper's children);
- the on-disk format is shared: a checkpoint of either package restores into the
  other where the states' dtypes agree (bfloat16 as raw bits included), and raises
  ``DtypeDriftError`` where a listed deviation differs (the int64 counts);
- N->M topology (2->1, 2->3) against one process on the union;
- the JAX package's cases on kill-before-commit, bit rot, truncation, torn
  manifests, stale generations and rename races, typed drift, retention, async
  saves (the port copies at the call: an update or a replay right after it changes
  nothing in the write).

Every test writes under ``tmp_path`` only and leaves no fault schedule, enabled
registry or ingest queue behind.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu import ckpt as jckpt
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.ckpt import (
    CapacityError,
    CheckpointError,
    CheckpointNotFoundError,
    CorruptCheckpointError,
    DtypeDriftError,
    IncompleteCheckpointError,
    SchemaDriftError,
    ShapeDriftError,
    TopologyError,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.obs import registry
from metrics_tpu_torch.serve import active_queues

CPU = "cpu"


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    yield
    ckpt.wait_for_all_saves()
    assert fault.current() is None
    assert registry._ENABLED is False
    assert active_queues() == []


def _np_leaves(value):
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _np_leaves(value[k])]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _np_leaves(v)]
    if isinstance(value, torch.Tensor):
        return [value.detach().cpu().numpy()]
    return [np.asarray(value)]


def _bit_equal(a, b):
    la, lb = _np_leaves(a), _np_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True) for x, y in zip(la, lb))


def _close(a, b, atol):
    la, lb = _np_leaves(a), _np_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), atol=atol, rtol=0, equal_nan=True)


# ------------------------------------------------------------------ metrics


class _CatSum(Metric):
    """A cat state and a sum state, for buffer-level tests."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("vals", [], dist_reduce_fx="cat", cat_item_shape=(), cat_dtype=torch.float32)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        x = torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32))
        self.vals.append(x)
        self.total = self.total + x.sum()

    def compute(self):
        from metrics_tpu_torch.core.state import cat_values

        return cat_values(self.vals).sum()


class _Vec(Metric):
    """Configurable schema for drift tests."""

    full_state_update = True

    def __init__(self, n=3, dtype=torch.float32, reduce="sum", **kwargs):
        super().__init__(**kwargs)
        self.add_state("v", torch.zeros(n, dtype=dtype), dist_reduce_fx=reduce)

    def update(self, x):
        self.v = self.v + torch.as_tensor(x, dtype=self.v.dtype)

    def compute(self):
        return self.v.sum()


class _Bf16Sum(Metric):
    """A bfloat16 state; the JAX twin below has the same class name and schema."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("v", torch.zeros(5, dtype=torch.bfloat16), dist_reduce_fx="sum")

    def update(self, x):
        self.v = self.v + torch.as_tensor(x).to(torch.bfloat16)

    def compute(self):
        return self.v


class _JaxBf16Sum(metrics_tpu.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("v", jnp.zeros(5, jnp.bfloat16), dist_reduce_fx="sum")

    def update(self, x):
        self.v = self.v + jnp.asarray(x).astype(jnp.bfloat16)

    def compute(self):
        return self.v


_JaxBf16Sum.__name__ = _JaxBf16Sum.__qualname__ = "_Bf16Sum"


class _Unreduced(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("raw", torch.zeros(3), dist_reduce_fx=None)

    def update(self, x):
        self.raw = self.raw + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.raw.sum()


def _acc(seed=0, n=64):
    from metrics_tpu_torch.classification import MulticlassAccuracy

    r = np.random.RandomState(seed)
    m = MulticlassAccuracy(num_classes=5, average="micro", device=CPU)
    m.update(torch.from_numpy(r.randint(0, 5, n)), torch.from_numpy(r.randint(0, 5, n)))
    return m


def _fresh_acc():
    from metrics_tpu_torch.classification import MulticlassAccuracy

    return MulticlassAccuracy(num_classes=5, average="micro", device=CPU)


# (name, torch maker, jax maker, batch maker, tolerance between the packages)
def _mc_batch(r):
    return r.rand(48, 5).astype(np.float32), r.randint(0, 5, 48)


def _bin_batch(r):
    return r.rand(96).astype(np.float32), r.randint(0, 2, 96)


def _sketch_batch(r):
    return (r.lognormal(0.0, 1.5, 200).astype(np.float32),)


def _ids_batch(r):
    return (r.randint(0, 3000, 500),)


CASES = {
    "MulticlassAccuracy": (
        lambda: metrics_tpu_torch.classification.MulticlassAccuracy(num_classes=5, device=CPU),
        lambda: metrics_tpu.classification.MulticlassAccuracy(num_classes=5),
        _mc_batch, 1e-6,
    ),
    "MulticlassConfusionMatrix": (
        lambda: metrics_tpu_torch.classification.MulticlassConfusionMatrix(num_classes=5, device=CPU),
        lambda: metrics_tpu.classification.MulticlassConfusionMatrix(num_classes=5),
        _mc_batch, 0,
    ),
    "BinaryAUROC_cat_capacity": (
        lambda: metrics_tpu_torch.classification.BinaryAUROC(cat_capacity=1024, device=CPU),
        lambda: metrics_tpu.classification.BinaryAUROC(cat_capacity=1024),
        _bin_batch, 1e-6,
    ),
    "BinaryAUROC_list": (
        lambda: metrics_tpu_torch.classification.BinaryAUROC(device=CPU),
        lambda: metrics_tpu.classification.BinaryAUROC(),
        _bin_batch, 1e-6,
    ),
    "QuantileSketch": (
        lambda: metrics_tpu_torch.sketches.QuantileSketch(device=CPU),
        lambda: metrics_tpu.sketches.QuantileSketch(),
        _sketch_batch, 1e-6,
    ),
    "DistinctCount": (
        lambda: metrics_tpu_torch.sketches.DistinctCount(p=10, device=CPU),
        lambda: metrics_tpu.sketches.DistinctCount(p=10),
        _ids_batch, 1e-6,
    ),
}
# the metrics whose states' dtypes agree between the packages: restorable across
SHARED_DTYPES = ("BinaryAUROC_cat_capacity", "BinaryAUROC_list", "QuantileSketch", "DistinctCount")
# listed deviations: the port counts in int64 where the JAX package keeps float32
DRIFTED = ("MulticlassAccuracy", "MulticlassConfusionMatrix")


def _batches(name, n=4, seed=3):
    r = np.random.RandomState(seed)
    return [CASES[name][2](r) for _ in range(n)]


def _feed_torch(m, batches):
    for b in batches:
        m.update(*(torch.from_numpy(np.asarray(x)) for x in b))
    return m


def _feed_jax(m, batches):
    for b in batches:
        m.update(*(jnp.asarray(x) for x in b))
    return m


@pytest.mark.parametrize("name", list(CASES))
def test_save_restore_continue_bit_equal_in_each_package(tmp_path, name):
    make_t, make_j, _, tol = CASES[name]
    batches = _batches(name)
    half = len(batches) // 2
    # the port: uninterrupted against saved at half, restored into a new object, continued
    whole_t = _feed_torch(make_t(), batches).compute()
    first = _feed_torch(make_t(), batches[:half])
    first.save_checkpoint(str(tmp_path / "t"))
    resumed = make_t()
    assert resumed.restore_checkpoint(str(tmp_path / "t")) == 0
    assert resumed._update_count == half
    got_t = _feed_torch(resumed, batches[half:]).compute()
    assert _bit_equal(got_t, whole_t)
    # the JAX package, the same way
    whole_j = _feed_jax(make_j(), batches).compute()
    first_j = _feed_jax(make_j(), batches[:half])
    first_j.save_checkpoint(str(tmp_path / "j"))
    resumed_j = make_j()
    resumed_j.restore_checkpoint(str(tmp_path / "j"))
    got_j = _feed_jax(resumed_j, batches[half:]).compute()
    assert _bit_equal(got_j, whole_j)
    _close(got_t, got_j, tol)


@pytest.mark.parametrize("name", SHARED_DTYPES)
def test_jax_checkpoint_restores_into_the_port(tmp_path, name):
    make_t, make_j, _, tol = CASES[name]
    batches = _batches(name, seed=5)
    _feed_jax(make_j(), batches[:2]).save_checkpoint(str(tmp_path))
    port = make_t()
    port.restore_checkpoint(str(tmp_path))
    _feed_torch(port, batches[2:])
    want = _feed_torch(make_t(), batches).compute()
    _close(port.compute(), want, 0)
    _close(port.compute(), _feed_jax(make_j(), batches).compute(), tol)


@pytest.mark.parametrize("name", SHARED_DTYPES)
def test_port_checkpoint_restores_into_jax(tmp_path, name):
    make_t, make_j, _, tol = CASES[name]
    batches = _batches(name, seed=6)
    _feed_torch(make_t(), batches[:2]).save_checkpoint(str(tmp_path))
    ref = make_j()
    ref.restore_checkpoint(str(tmp_path))
    _feed_jax(ref, batches[2:])
    want = _feed_jax(make_j(), batches).compute()
    _close(ref.compute(), want, 0)
    _close(ref.compute(), _feed_torch(make_t(), batches).compute(), tol)


@pytest.mark.parametrize("name", DRIFTED)
def test_listed_dtype_deviation_raises_dtype_drift_both_ways(tmp_path, name):
    make_t, make_j, _, _ = CASES[name]
    batches = _batches(name, n=1)
    _feed_jax(make_j(), batches).save_checkpoint(str(tmp_path / "j"))
    port = _feed_torch(make_t(), batches)
    before = {k: v.clone() for k, v in port.metric_state.items()}
    with pytest.raises(DtypeDriftError):
        port.restore_checkpoint(str(tmp_path / "j"))
    assert _bit_equal(port.metric_state, before)  # untouched
    _feed_torch(make_t(), batches).save_checkpoint(str(tmp_path / "t"))
    with pytest.raises(jckpt.DtypeDriftError):
        make_j().restore_checkpoint(str(tmp_path / "t"))


def test_bfloat16_state_shares_its_raw_bits_both_ways(tmp_path):
    x = np.random.RandomState(1).randn(5).astype(np.float32) * 3
    jm = _JaxBf16Sum()
    jm.update(jnp.asarray(x))
    jm.save_checkpoint(str(tmp_path / "j"))
    tm = _Bf16Sum(device=CPU)
    tm.restore_checkpoint(str(tmp_path / "j"))
    assert tm.v.dtype == torch.bfloat16
    jbits = np.asarray(jm.v).view(np.uint16)
    assert np.array_equal(tm.v.view(torch.int16).numpy().view(np.uint16), jbits)
    tm.save_checkpoint(str(tmp_path / "t"))
    back = _JaxBf16Sum()
    back.restore_checkpoint(str(tmp_path / "t"))
    assert np.array_equal(np.asarray(back.v).view(np.uint16), jbits)
    # the payload bytes are the same on both sides
    blobs = [open(os.path.join(str(tmp_path / k), "step_0000000000", "arrays-h0000.bin"), "rb").read() for k in "jt"]
    assert blobs[0] == blobs[1]
    index = json.load(open(os.path.join(str(tmp_path / "t"), "step_0000000000", "manifest-h0000.json")))
    assert index["payload"]["index"]["v"]["dtype"] == "bfloat16"


def test_manifest_matches_the_jax_package_key_for_key(tmp_path):
    make_t, make_j, _, _ = CASES["BinaryAUROC_cat_capacity"]
    batches = _batches("BinaryAUROC_cat_capacity", n=2)
    _feed_torch(make_t(), batches).save_checkpoint(str(tmp_path / "t"))
    _feed_jax(make_j(), batches).save_checkpoint(str(tmp_path / "j"))
    mt, mj = (json.load(open(os.path.join(str(tmp_path / k), "step_0000000000", "manifest-h0000.json"))) for k in "tj")
    for m in (mt, mj):
        m.pop("generation")
    assert mt["tree"] == mj["tree"]
    assert set(mt) == set(mj)
    for key, entry in mj["payload"]["index"].items():
        got = mt["payload"]["index"][key]
        assert (got["dtype"], got["shape"], got["offset"], got["nbytes"]) == (
            entry["dtype"], entry["shape"], entry["offset"], entry["nbytes"]
        )
    assert set(os.listdir(os.path.join(str(tmp_path / "t"), "step_0000000000"))) == set(
        os.listdir(os.path.join(str(tmp_path / "j"), "step_0000000000"))
    )


# ------------------------------------------------------------------ basics


def test_versioned_steps_and_retention(tmp_path):
    d = str(tmp_path)
    m = _acc()
    for expect in range(4):
        handle = m.save_checkpoint(d, retain=2)
        assert handle.step == expect
        assert handle.result().endswith(f"step_{expect:010d}")
    assert ckpt.all_steps(d) == [2, 3]
    assert ckpt.latest_step(d) == 3


def test_explicit_step_collision_and_missing_raise(tmp_path):
    m = _acc()
    m.save_checkpoint(str(tmp_path), step=5)
    with pytest.raises(CheckpointError):
        m.save_checkpoint(str(tmp_path), step=5)
    with pytest.raises(CheckpointNotFoundError):
        _acc().restore_checkpoint(str(tmp_path / "none"))
    with pytest.raises(CheckpointNotFoundError):
        _acc().restore_checkpoint(str(tmp_path), step=3)


def test_async_save_copies_before_it_returns(tmp_path):
    m = _acc()
    want = m.compute().clone()
    tp = m.tp
    handle = m.save_checkpoint(str(tmp_path), blocking=False)
    tp.add_(1000)  # an in-place write right after the call reaches nothing in flight
    m.update(torch.from_numpy(np.arange(64) % 5), torch.from_numpy(np.arange(64) % 5))
    handle.result(timeout=60)
    assert handle.committed
    fresh = _fresh_acc()
    fresh.restore_checkpoint(str(tmp_path))
    assert torch.equal(fresh.compute(), want)


def test_async_auto_step_saves_never_collide(tmp_path):
    d = str(tmp_path)
    m = _acc()
    handles = [m.save_checkpoint(d, blocking=False) for _ in range(8)]
    ckpt.wait_for_all_saves()
    assert [h.step for h in handles] == list(range(8))
    assert ckpt.all_steps(d) == list(range(8))
    assert ckpt.secure_pending_snapshots([m.tp]) == 0  # the port's snapshots are copies
    for step in range(8):
        assert _fresh_acc().restore_checkpoint(d, step=step) == step


# --------------------------------------------------------------- atomicity


def test_kill_before_commit_leaves_no_readable_checkpoint(tmp_path, monkeypatch):
    from metrics_tpu_torch.ckpt import manager

    d = str(tmp_path)
    m = _acc()
    monkeypatch.setattr(
        manager._serializer, "write_payload", lambda *a, **k: (_ for _ in ()).throw(KeyboardInterrupt("preempted"))
    )
    with pytest.raises(KeyboardInterrupt):
        m.save_checkpoint(d)
    monkeypatch.undo()
    monkeypatch.setattr(manager.os, "rename", lambda *a: (_ for _ in ()).throw(OSError("preempted")))
    with pytest.raises(OSError):
        m.save_checkpoint(d, step=9, retries=1)
    monkeypatch.undo()
    assert ckpt.all_steps(d) == []
    with pytest.raises(CheckpointNotFoundError):
        _acc().restore_checkpoint(d)
    with pytest.raises(IncompleteCheckpointError):
        _acc().restore_checkpoint(d, step=9)
    m.save_checkpoint(d, step=10)
    fresh = _fresh_acc()
    assert fresh.restore_checkpoint(d) == 10
    assert torch.equal(fresh.compute(), m.compute())


def test_committed_dir_without_commit_record_is_incomplete(tmp_path):
    d = str(tmp_path)
    _acc().save_checkpoint(d, step=0)
    os.remove(os.path.join(d, "step_0000000000", "COMMIT"))
    assert ckpt.all_steps(d) == []
    with pytest.raises(IncompleteCheckpointError):
        _acc().restore_checkpoint(d, step=0)


@pytest.mark.parametrize("damage", ["truncate", "bitrot", "manifest"])
def test_damaged_checkpoint_raises_corrupt_and_leaves_the_metric(tmp_path, damage):
    d = str(tmp_path)
    _acc(seed=1).save_checkpoint(d)
    step_dir = os.path.join(d, "step_0000000000")
    payload = os.path.join(step_dir, "arrays-h0000.bin")
    if damage == "truncate":
        with open(payload, "r+b") as fh:
            fh.truncate(os.path.getsize(payload) // 2)
        match = "truncated"
    elif damage == "bitrot":
        with open(payload, "r+b") as fh:
            first = fh.read(1)
            fh.seek(0)
            fh.write(bytes([first[0] ^ 0xFF]))
        match = "checksum"
    else:
        with open(os.path.join(step_dir, "manifest-h0000.json"), "w") as fh:
            fh.write('{"format": "metrics_tpu.ck')
        match = "manifest"
    live = _acc(seed=2)
    before = live.compute().clone()
    with pytest.raises(CorruptCheckpointError, match=match):
        live.restore_checkpoint(d)
    assert torch.equal(live.compute(), before)
    # the JAX package rejects the same damage
    with pytest.raises(jckpt.CorruptCheckpointError, match=match):
        metrics_tpu.classification.MulticlassAccuracy(num_classes=5, average="micro").restore_checkpoint(d)


def test_schema_drift_typed_errors(tmp_path):
    d = str(tmp_path)
    m = _Vec(n=3, device=CPU)
    m.update(torch.ones(3))
    m.save_checkpoint(d)
    with pytest.raises(ShapeDriftError):
        _Vec(n=4, device=CPU).restore_checkpoint(d)
    with pytest.raises(DtypeDriftError):
        _Vec(n=3, dtype=torch.int32, device=CPU).restore_checkpoint(d)
    with pytest.raises(SchemaDriftError):
        _Vec(n=3, reduce="max", device=CPU).restore_checkpoint(d)
    with pytest.raises(SchemaDriftError):
        _fresh_acc().restore_checkpoint(d)
    clean = _Vec(n=4, device=CPU)
    clean.update(torch.ones(4))
    with pytest.raises(ShapeDriftError):
        clean.restore_checkpoint(d)
    assert float(clean.compute()) == 4.0


# ------------------------------------------------------------- cat buffers


def test_catbuffer_count_and_overflow_survive_roundtrip(tmp_path):
    d = str(tmp_path)
    m = _CatSum(cat_capacity=4, device=CPU)
    m.update(torch.arange(3.0))
    m.update(torch.arange(3.0))  # a true count of 6 in a capacity of 4
    assert m.vals.overflowed()
    m.save_checkpoint(d)
    same = _CatSum(cat_capacity=4, device=CPU)
    same.restore_checkpoint(d)
    assert int(same.vals.count) == 6 and same.vals.overflowed()
    assert torch.equal(same.vals.data, m.vals.data)
    bigger = _CatSum(cat_capacity=16, device=CPU)
    bigger.restore_checkpoint(d)
    assert int(bigger.vals.count) == 4 and bigger.vals.overflowed()
    with pytest.raises(CapacityError):
        _CatSum(cat_capacity=2, device=CPU).restore_checkpoint(d)


def test_list_cat_state_roundtrip_ragged(tmp_path):
    d = str(tmp_path)
    m = _CatSum(device=CPU)
    m.update(torch.arange(3.0))
    m.update(torch.arange(5.0))
    m.save_checkpoint(d)
    fresh = _CatSum(device=CPU)
    fresh.restore_checkpoint(d)
    assert [tuple(v.shape) for v in fresh.vals] == [(3,), (5,)]
    assert float(fresh.compute()) == float(m.compute())


# ------------------------------------------------------- collections/groups


def _canonical_batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [(r.rand(64).astype(np.float32), r.randint(0, 2, 64).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_five_group_collection_restore_continue_bit_equal(tmp_path, fused):
    from metrics_tpu.core.fused import canonical_collection as jax_canonical
    from metrics_tpu_torch.core.fused import canonical_collection

    batches = _canonical_batches(6)
    whole = canonical_collection(fused, device=CPU)
    _feed_torch(whole, batches)
    first = canonical_collection(fused, device=CPU)
    _feed_torch(first, batches[:3])
    first.save_checkpoint(str(tmp_path))
    manifest = json.load(open(os.path.join(str(tmp_path), "step_0000000000", "manifest-h0000.json")))
    assert {k.split("/")[0] for k in manifest["payload"]["index"]} == {g[0] for g in manifest["tree"]["groups"]}
    # restore into a collection that already stepped: its next step must start from the restored states
    resumed = canonical_collection(fused, device=CPU)
    _feed_torch(resumed, batches[5:])
    resumed.restore_checkpoint(str(tmp_path))
    _feed_torch(resumed, batches[3:])
    assert _bit_equal(resumed.compute(), whole.compute())
    jax_whole = jax_canonical(fused)
    _feed_jax(jax_whole, batches)
    _close(resumed.compute(), jax_whole.compute(), 1e-6)


def test_collection_group_realiasing_and_name_drift(tmp_path):
    from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassPrecision, MulticlassRecall
    from metrics_tpu_torch.core import MetricCollection

    def make():
        return MetricCollection([MulticlassAccuracy(num_classes=5, device=CPU), MulticlassPrecision(num_classes=5, device=CPU),
                                 MulticlassRecall(num_classes=5, device=CPU)])

    r = np.random.RandomState(4)
    mc = make()
    assert any(len(g) > 1 for g in mc.compute_groups.values())
    mc.update(torch.from_numpy(r.randint(0, 5, 64)), torch.from_numpy(r.randint(0, 5, 64)))
    mc.save_checkpoint(str(tmp_path))
    mc2 = make()
    mc2.restore_checkpoint(str(tmp_path))
    for group in mc2.compute_groups.values():
        leader = mc2._modules[group[0]]
        for name in group[1:]:
            assert all(getattr(mc2._modules[name], s) is getattr(leader, s) for s in leader._defaults)
            assert mc2._modules[name]._update_count == leader._update_count
    p, t = torch.from_numpy(r.randint(0, 5, 32)), torch.from_numpy(r.randint(0, 5, 32))
    mc.update(p, t)
    mc2.update(p, t)
    assert _bit_equal(mc2.compute(), mc.compute())
    with pytest.raises(SchemaDriftError, match="names"):
        MetricCollection([MulticlassAccuracy(num_classes=5, device=CPU)]).restore_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointError, match="collection"):
        _fresh_acc().restore_checkpoint(str(tmp_path))


# ------------------------------------------------------------ fleet, wrappers


def test_fleet_roundtrip_and_stream_slice(tmp_path):
    from metrics_tpu_torch.classification import MulticlassAccuracy

    r = np.random.RandomState(0)
    fleet = MulticlassAccuracy(num_classes=3, average=None, fleet_size=4, device=CPU)
    refs = [MulticlassAccuracy(num_classes=3, average=None, device=CPU) for _ in range(4)]
    jfleet = metrics_tpu.classification.MulticlassAccuracy(num_classes=3, average=None, fleet_size=4)
    for _ in range(3):
        p, t, ids = r.randint(0, 3, 32), r.randint(0, 3, 32), r.randint(0, 4, 32).astype(np.int32)
        fleet.update(torch.from_numpy(p), torch.from_numpy(t), stream_ids=torch.from_numpy(ids))
        jfleet.update(jnp.asarray(p), jnp.asarray(t), stream_ids=jnp.asarray(ids))
        for s, ref in enumerate(refs):
            if (ids == s).any():
                ref.update(torch.from_numpy(p[ids == s]), torch.from_numpy(t[ids == s]))
    fleet.save_checkpoint(str(tmp_path))
    whole = MulticlassAccuracy(num_classes=3, average=None, fleet_size=4, device=CPU)
    whole.restore_checkpoint(str(tmp_path))
    assert _bit_equal(whole.compute(), fleet.compute())
    for s, ref in enumerate(refs):
        one = MulticlassAccuracy(num_classes=3, average=None, device=CPU)
        one.restore_checkpoint(str(tmp_path), stream=s)
        assert torch.equal(one.tp, ref.tp) and _bit_equal(one.compute(), ref.compute())
    _close(whole.compute(), jfleet.compute(), 1e-6)
    with pytest.raises(CheckpointError, match="out of range"):
        MulticlassAccuracy(num_classes=3, average=None, device=CPU).restore_checkpoint(str(tmp_path), stream=4)
    with pytest.raises(ShapeDriftError, match="fleet_size=4 != live fleet_size=5"):
        MulticlassAccuracy(num_classes=3, average=None, fleet_size=5, device=CPU).restore_checkpoint(str(tmp_path))


def test_bootstrapper_children_roundtrip(tmp_path):
    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.wrappers import BootStrapper, MinMaxMetric

    batches = _batches("BinaryAUROC_list", n=4, seed=9)
    whole = _feed_torch(BootStrapper(BinaryAUROC(device=CPU), num_bootstraps=3, seed=0), batches)
    first = _feed_torch(BootStrapper(BinaryAUROC(device=CPU), num_bootstraps=3, seed=0), batches[:2])
    first.save_checkpoint(str(tmp_path / "boot"))
    manifest = json.load(open(os.path.join(str(tmp_path / "boot"), "step_0000000000", "manifest-h0000.json")))
    assert sorted(manifest["tree"]["schema"]["children"]) == ["metrics"]
    assert any(k.startswith("metrics[2]/preds#") for k in manifest["payload"]["index"])
    resumed = BootStrapper(BinaryAUROC(device=CPU), num_bootstraps=3, seed=0)
    resumed.restore_checkpoint(str(tmp_path / "boot"))
    assert [c._update_count for c in resumed.metrics] == [c._update_count for c in first.metrics]
    for a, b in zip(resumed.metrics, first.metrics):
        assert _bit_equal(a.metric_state, b.metric_state)
    assert _bit_equal(resumed.compute(), first.compute())
    # the host draw stream is no state (in neither package): the resumed wrapper
    # takes the saved one's position in it, then continues bit-equal
    resumed._rng.bit_generator.state = first._rng.bit_generator.state
    _feed_torch(resumed, batches[2:])
    assert _bit_equal(resumed.compute(), whole.compute())
    # a wrapper over one base metric: the child rides under its attribute name
    mm = MinMaxMetric(CASES["MulticlassAccuracy"][0]())
    _feed_torch(mm, _batches("MulticlassAccuracy", n=3))
    mm.save_checkpoint(str(tmp_path / "minmax"))
    fresh = MinMaxMetric(CASES["MulticlassAccuracy"][0]())
    fresh.restore_checkpoint(str(tmp_path / "minmax"))
    assert _bit_equal(fresh.compute(), mm.compute())


# ------------------------------------------------- many hosts, topology


def test_multihost_commit_requires_all_manifests(tmp_path):
    d = str(tmp_path)
    _acc().save_checkpoint(d, step=3, process_index=1, process_count=2)
    assert ckpt.all_steps(d) == []
    with pytest.raises(CheckpointNotFoundError):
        _acc().restore_checkpoint(d)
    _acc().save_checkpoint(d, step=3, process_index=0, process_count=2)
    assert ckpt.all_steps(d) == [3]
    step_dir = os.path.join(d, "step_0000000003")
    assert json.load(open(os.path.join(step_dir, "COMMIT")))["world"] == 2
    m_h1 = json.load(open(os.path.join(step_dir, "manifest-h0001.json")))
    assert "tp" not in m_h1["payload"]["index"]  # replicated arrays: host 0 writes them once


def test_stale_manifest_from_dead_incarnation_never_commits(tmp_path):
    d = str(tmp_path)
    _acc().save_checkpoint(d, step=0, process_index=1, process_count=2, generation="gen-dead")
    h0 = _acc().save_checkpoint(d, step=0, process_index=0, process_count=2, generation="gen-live")
    assert ckpt.all_steps(d) == [] and not h0.committed
    h1 = _acc().save_checkpoint(d, step=0, process_index=1, process_count=2, generation="gen-live")
    assert ckpt.all_steps(d) == [0] and h1.committed and h0.committed
    step_dir = os.path.join(d, "step_0000000000")
    for host in range(2):
        assert json.load(open(os.path.join(step_dir, f"manifest-h{host:04d}.json")))["generation"] == "gen-live"
    # a preempted two-host incarnation's shards are swept by a one-host commit
    e = str(tmp_path / "sweep")
    _acc().save_checkpoint(e, step=0, process_index=1, process_count=2, generation="gen-dead")
    _acc().save_checkpoint(e, step=0)
    assert not os.path.exists(os.path.join(e, "step_0000000000", "manifest-h0001.json"))


def test_commit_write_losing_rename_race_is_success(tmp_path, monkeypatch):
    from metrics_tpu_torch.ckpt import manager

    d = str(tmp_path)
    _acc().save_checkpoint(d, step=0, process_index=1, process_count=2)
    real = manager._atomic_write_json
    tmp_dir, final_dir = os.path.join(d, ".tmp-step_0000000000"), os.path.join(d, "step_0000000000")

    def racing(path, payload):
        if os.path.basename(path) == "COMMIT" and os.path.isdir(tmp_dir):
            real(path, payload)
            os.rename(tmp_dir, final_dir)
            raise FileNotFoundError(path + ".part")
        return real(path, payload)

    monkeypatch.setattr(manager, "_atomic_write_json", racing)
    h = _acc().save_checkpoint(d, step=0, process_index=0, process_count=2)
    assert h.committed and ckpt.all_steps(d) == [0]


def test_wait_for_all_saves_surfaces_uncommitted_steps(tmp_path):
    from metrics_tpu_torch.ckpt import manager

    d = str(tmp_path)
    h = _acc().save_checkpoint(d, step=0, process_index=1, process_count=2)
    assert h.done() and not h.committed
    with manager._INFLIGHT_LOCK:
        manager._INFLIGHT.append(h)
    try:
        with pytest.warns(RuntimeWarning, match="not committed"):
            ckpt.wait_for_all_saves()
        with pytest.raises(IncompleteCheckpointError, match="not committed"):
            ckpt.wait_for_all_saves(require_committed=True)
    finally:
        with manager._INFLIGHT_LOCK:
            manager._INFLIGHT.remove(h)
    _acc().save_checkpoint(d, step=0, process_index=0, process_count=2)
    assert h.committed


def test_generation_nonce_comes_from_rank_zero_over_a_process_group(monkeypatch):
    import torch.distributed as dist

    from metrics_tpu_torch.ckpt import manager

    sent = []

    def broadcast(box, src):
        sent.append((list(box), src))
        box[0] = 0xABC

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "broadcast_object_list", broadcast)
    monkeypatch.setattr(manager, "_GENERATION", {})
    assert manager._save_generation(2) == f"{0xABC:016x}"
    assert manager._save_generation(2) == f"{0xABC:016x}"
    assert len(sent) == 1 and sent[0][1] == 0  # once per process, from rank 0
    assert manager._save_generation(3) == "-"  # a topology the group does not have
    assert manager._save_generation(1) != "-"


def _union_acc(datas):
    m = _fresh_acc()
    for p, t in datas:
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    return m


@pytest.mark.parametrize("world", [1, 3], ids=["2to1", "2to3"])
def test_topology_change_against_one_process_on_the_union(tmp_path, world):
    from metrics_tpu_torch.sketches import DistinctCount

    r = np.random.RandomState(11)
    datas = [(r.randint(0, 5, 40), r.randint(0, 5, 40)) for _ in range(2)]
    chunks = [np.arange(5.0), np.arange(5.0, 8.0)]
    ids = [r.randint(0, 3000, 4000), r.randint(2000, 8000, 4000)]
    for rank in range(2):
        m = _fresh_acc()
        m.update(torch.from_numpy(datas[rank][0]), torch.from_numpy(datas[rank][1]))
        m.save_checkpoint(str(tmp_path / "sum"), step=0, process_index=rank, process_count=2, replicated=False)
        c = _CatSum(cat_capacity=8, device=CPU)
        c.update(torch.from_numpy(chunks[rank]))
        c.save_checkpoint(str(tmp_path / "cat"), step=0, process_index=rank, process_count=2, replicated=False)
        h = DistinctCount(p=10, device=CPU)
        h.update(torch.from_numpy(ids[rank]))
        h.save_checkpoint(str(tmp_path / "max"), step=0, process_index=rank, process_count=2, replicated=False)
    union = _union_acc(datas)
    oracle = DistinctCount(p=10, device=CPU)
    oracle.update(torch.from_numpy(np.concatenate(ids)))
    tps, rows = [], []
    for rank in range(world):
        m = _fresh_acc()
        m.restore_checkpoint(str(tmp_path / "sum"), process_index=rank, process_count=world)
        tps.append(m.tp)
        c = _CatSum(cat_capacity=8, device=CPU)
        c.restore_checkpoint(str(tmp_path / "cat"), process_index=rank, process_count=world)
        rows.extend(c.vals.values().tolist())
        h = DistinctCount(p=10, device=CPU)
        h.restore_checkpoint(str(tmp_path / "max"), process_index=rank, process_count=world)
        assert torch.equal(h.registers, oracle.registers)  # max states merge on every host
        if world == 1:
            assert _bit_equal(m.compute(), union.compute())
    assert torch.equal(sum(tps), union.tp)  # rank 0 owns the sum, the others hold defaults
    assert rows == np.concatenate(chunks).tolist()  # every row on one host, in order


def test_topology_change_unreduced_state_raises(tmp_path):
    d = str(tmp_path)
    for rank in range(2):
        m = _Unreduced(device=CPU)
        m.update(torch.ones(3) * (rank + 1))
        m.save_checkpoint(d, step=0, process_index=rank, process_count=2, replicated=False)
    ok = _Unreduced(device=CPU)
    ok.restore_checkpoint(d, process_index=1, process_count=2)
    assert torch.equal(ok.raw, 2 * torch.ones(3))
    with pytest.raises(TopologyError):
        _Unreduced(device=CPU).restore_checkpoint(d, process_index=0, process_count=1)


def test_persistent_only_saves_subset(tmp_path):
    d = str(tmp_path)
    m = _CatSum(cat_capacity=8, device=CPU)
    m.persistent(True)
    m._persistent["vals"] = False
    m.update(torch.arange(4.0))
    m.save_checkpoint(d, persistent_only=True)
    manifest = json.load(open(os.path.join(d, "step_0000000000", "manifest-h0000.json")))
    assert set(manifest["tree"]["schema"]["states"]) == {"total"}
    fresh = _CatSum(cat_capacity=8, device=CPU)
    fresh.restore_checkpoint(d)
    assert float(fresh.total) == 6.0 and int(fresh.vals.count) == 0


def test_registry_counters_only_when_enabled(tmp_path):
    m = _acc()
    obs.REGISTRY.clear()
    m.save_checkpoint(str(tmp_path / "off"))
    assert not obs.REGISTRY.recorded()  # off by default: nothing written
    with obs.observe(clear=True) as reg:
        m.save_checkpoint(str(tmp_path / "on"))
        _fresh_acc().restore_checkpoint(str(tmp_path / "on"))
        assert reg.get("ckpt", "saves") == 1 and reg.get("ckpt", "restores") == 1
        assert reg.get("ckpt", "bytes") > 0
    obs.REGISTRY.clear()
    assert m._ckpt_stats["last_save_step"] == 0


def test_async_save_of_a_stepping_fused_collection_is_the_state_at_the_call(tmp_path):
    from metrics_tpu_torch.core.fused import canonical_collection

    batches = _canonical_batches(4, seed=2)
    coll = canonical_collection(True, device=CPU)
    _feed_torch(coll, batches[:2])
    want = {k: v.clone() for k, v in coll.compute().items()}
    handle = coll.save_checkpoint(str(tmp_path), blocking=False)
    _feed_torch(coll, batches[2:])  # steps while the writer runs
    handle.result(timeout=60)
    fresh = canonical_collection(True, device=CPU)
    fresh.restore_checkpoint(str(tmp_path))
    assert _bit_equal(fresh.compute(), want)
