"""metrics_tpu_torch.serve.IngestQueue against the JAX package's, on the CPU.

The contract is **bit-equality**: batches staged through the queue and applied by
coalesced ticks leave the target in the state of synchronous ``update`` calls on the
same batches in the same order (a fused collection, mixed batch shapes, a fleet, bare
metrics with sum, max and ``CatBuffer`` states, and an unchainable target applied
eagerly inside the tick). The flushed values also agree with the JAX package's queue
on the same numpy batches. Then the staging ring, the three backpressure modes,
``max_staleness_s``, the background ticker against a producer thread, ``close`` with
and without drain, flush-before-save, the enqueue aliasing rule, and the degrade
ladder (an ``ingest.tick`` fault applies the batches synchronously, bit-equal).

On the card a tick of k batches is one CUDA-graph replay; that is held in
``tests/test_torch_kernels.py``. Every test leaves no queue, schedule or enabled
registry behind.
"""
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import serve as jserve
from metrics_tpu.core.fused import canonical_collection as jax_canonical
from metrics_tpu_torch import ckpt, fault, obs
from metrics_tpu_torch.classification import BinaryAUROC
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.core import fused as _fused
from metrics_tpu_torch.core.fused import canonical_collection
from metrics_tpu_torch.image import PeakSignalNoiseRatio
from metrics_tpu_torch.obs import registry
from metrics_tpu_torch.obs.ring import Ring
from metrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError, SpearmanCorrCoef
from metrics_tpu_torch.serve import IngestBackpressureError, IngestQueue, active_queues, flush_for, max_queue_depth
from tests.torch_deadline import deadline  # noqa: F401
from tests.torch_globals import restores_globals  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _leaves_nothing_behind(restores_globals):
    _fused._DEGRADE_WARNED.clear()
    yield
    _fused._DEGRADE_WARNED.clear()
    ckpt.wait_for_all_saves(timeout_s=60)
    assert fault.current() is None
    assert registry._ENABLED is False
    assert active_queues() == []


def _batches(n, rows=32, seed=7):
    r = np.random.RandomState(seed)
    return [(r.rand(rows).astype(np.float32), r.randint(0, 2, rows).astype(np.int32)) for _ in range(n)]


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _leaves(v):
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _leaves(v[k])]
    if isinstance(v, torch.Tensor):
        return [v.detach().numpy()]
    return [np.asarray(v)]


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True) for x, y in zip(la, lb))


def _close(a, b, atol=1e-6):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), atol=atol, rtol=0)


# ------------------------------------------------------------------- ring


def test_ring_evicts_refuses_drains_in_order():
    r = Ring(3)
    for i in range(5):
        r.append(i)
    assert r.snapshot() == [2, 3, 4] and r.full
    assert not r.try_append(9)
    assert r.drain(limit=2) == [2, 3] and r.try_append(5)
    assert r.pop_oldest() == 4 and r.drain() == [5] and r.pop_oldest() is None
    r.append(1)
    r.clear()
    assert len(r) == 0 and r.capacity == 3
    with pytest.raises(ValueError):
        Ring(0)


# ----------------------------------------------------------- bit-equality


def test_fused_collection_bit_equal_and_agrees_with_the_jax_queue():
    batches = _batches(12)
    sync = canonical_collection(True, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    with IngestQueue(canonical_collection(True, device=CPU), capacity=32, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t))
        q.flush()
        assert q.stats["launches"] == 1 and q.stats["degrades"] == 0
        got = q.compute()
    assert _bitwise(sync.compute(), got)
    with jserve.IngestQueue(jax_canonical(True), capacity=32, start=False) as jq:
        for p, t in batches:
            jq.enqueue(jnp.asarray(p), jnp.asarray(t))
        jq.flush()
        _close(got, jq.compute())


def test_mixed_shapes_key_each_entry_bit_equal():
    batches = _batches(3, rows=8) + _batches(3, rows=16, seed=11)

    def make():
        return MetricCollection({"mse": MeanSquaredError(device=CPU), "mae": MeanAbsoluteError(device=CPU)}, fused=True)

    sync = make()
    for p, t in batches:
        sync.update(*_t(p, t.astype(np.float32)))
    with IngestQueue(make(), capacity=32, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t.astype(np.float32)))
        q.flush()
        assert q.stats["launches"] == 1
        key = next(iter(q._steps.steps))
        assert len(key[2]) == 6  # one signature an entry
        assert _bitwise(sync.compute(), q.compute())


def test_fleet_bit_equal():
    batches = _batches(10, rows=16)
    ids = torch.arange(16, dtype=torch.int32) % 4
    sync = MeanSquaredError(fleet_size=4, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t.astype(np.float32)), stream_ids=ids)
    with IngestQueue(MeanSquaredError(fleet_size=4, device=CPU), capacity=32, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t.astype(np.float32)), stream_ids=ids)
        q.flush()
        assert q.stats["launches"] == 1
        assert _bitwise(sync.compute(), q.compute())


@pytest.mark.parametrize(
    "factory",
    [lambda: MeanSquaredError(device=CPU), lambda: PeakSignalNoiseRatio(data_range=None, device=CPU),
     lambda: SpearmanCorrCoef(cat_capacity=512, device=CPU)],
    ids=["sum", "max", "cat_buffer"],
)
def test_bare_metric_bit_equal_to_synchronous_updates(factory):
    batches = _batches(8, rows=16)
    sync = factory()
    for p, t in batches:
        sync.update(*_t(p, t.astype(np.float32)))
    with IngestQueue(factory(), capacity=32, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t.astype(np.float32)))
        q.flush()
        chained = q.stats["launches"] == 1 and q.stats["eager_entries"] == 0
        # a CatBuffer's append offset is a host count: applied eagerly inside the tick
        assert chained != isinstance(q.target, SpearmanCorrCoef)
        assert _bitwise(sync.compute(), q.compute())


def test_unchainable_target_is_applied_eagerly_inside_the_tick():
    batches = _batches(6, rows=16)
    sync = BinaryAUROC(device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    with IngestQueue(BinaryAUROC(device=CPU), capacity=16, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t))
        q.flush()
        assert q.stats["launches"] == 0 and q.stats["eager_entries"] == len(batches)
        assert _bitwise(sync.compute(), q.compute())


def test_an_enqueued_tensor_is_kept_not_copied():
    """The aliasing rule: the queue keeps the caller's tensors. An in-place write
    before the batch is applied changes what is applied; after it, nothing."""
    target = MeanSquaredError(device=CPU)
    with IngestQueue(target, capacity=4, start=False) as q:
        p, t = torch.zeros(4), torch.zeros(4)
        q.enqueue(p, t)
        p.fill_(2.0)  # before the tick: the queue sees the new values
        q.flush()
        assert float(target.compute()) == 4.0
        p.fill_(100.0)  # after it: the state is untouched
        assert float(target.compute()) == 4.0


# ------------------------------------------------------------ backpressure


def test_backpressure_raise_and_block_timeout():
    with IngestQueue(MeanSquaredError(device=CPU), capacity=2, backpressure="raise", start=False) as q:
        q.enqueue(torch.ones(4), torch.zeros(4))
        q.enqueue(torch.ones(4), torch.zeros(4))
        with pytest.raises(IngestBackpressureError, match="full"):
            q.enqueue(torch.ones(4), torch.zeros(4))
        assert q.depth == 2
    with IngestQueue(MeanSquaredError(device=CPU), capacity=1, block_timeout_s=0.05, start=False) as q:
        q.enqueue(torch.ones(4), torch.zeros(4))
        with pytest.raises(IngestBackpressureError, match="blocked"):
            q.enqueue(torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="backpressure"):
        IngestQueue(MeanSquaredError(device=CPU), backpressure="spill", start=False)


def test_backpressure_drop_oldest_keeps_the_newest():
    batches = _batches(5, rows=8)
    sync = MeanSquaredError(device=CPU)
    for p, t in batches[-2:]:
        sync.update(*_t(p, t.astype(np.float32)))
    with IngestQueue(MeanSquaredError(device=CPU), capacity=2, backpressure="drop_oldest", start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t.astype(np.float32)))
        assert q.stats["dropped"] == 3
        q.flush()
        assert _bitwise(sync.compute(), q.compute())


def test_backpressure_block_unblocks_through_the_background_ticker():
    target = MeanSquaredError(device=CPU)
    with IngestQueue(target, capacity=4, tick_interval_s=0.001, block_timeout_s=10.0) as q:
        for p, t in _batches(32, rows=8):
            q.enqueue(*_t(p, t.astype(np.float32)))
        q.flush()
        assert q.stats["enqueued"] == 32 and q.stats["dropped"] == 0 and target._update_count == 32


# ------------------------------------------- background ticker, staleness


def test_producer_thread_against_the_background_ticker_bit_equal():
    batches = _batches(40, rows=8)
    sync = canonical_collection(True, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    target = canonical_collection(True, device=CPU)
    errors = []
    with IngestQueue(target, capacity=64, tick_interval_s=0.001) as q:

        def produce():
            try:
                for p, t in batches:
                    q.enqueue(*_t(p, t))
            except BaseException as err:  # noqa: BLE001
                errors.append(err)

        producer = threading.Thread(target=produce)
        producer.start()
        for _ in range(5):
            q.compute()  # flush-before-read under contention
        producer.join(timeout=30)
        assert not producer.is_alive() and not errors
        q.flush()
        assert q.stats["ticks"] >= 1 and q.stats["degrades"] == 0
    assert _bitwise(sync.compute(), target.compute())
    assert target["MeanSquaredError"]._update_count == 40


def test_background_ticker_applies_without_a_flush():
    target = MeanSquaredError(device=CPU)
    with IngestQueue(target, capacity=64, tick_interval_s=0.001) as q:
        for p, t in _batches(8, rows=8):
            q.enqueue(*_t(p, t.astype(np.float32)))
        deadline = time.monotonic() + 10.0
        while target._update_count < 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert q.depth == 0 and target._update_count == 8


def test_compute_flushes_unless_within_max_staleness():
    batches = _batches(4, rows=8)
    sync = canonical_collection(True, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    with IngestQueue(canonical_collection(True, device=CPU), capacity=16, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t))
        assert q.depth == 4
        assert _bitwise(sync.compute(), q.compute()) and q.depth == 0
    target = MeanSquaredError(device=CPU)
    with IngestQueue(target, capacity=16, max_staleness_s=3600.0, start=False) as q:
        for p, t in batches[:2]:
            q.enqueue(*_t(p, t.astype(np.float32)))
        q.flush()
        ticked = q.compute().clone()
        for p, t in batches[2:]:
            q.enqueue(*_t(p, t.astype(np.float32)))
        assert torch.equal(q.compute(), ticked) and q.depth == 2
        q.flush()
        assert not torch.equal(q.compute(), ticked)


# ---------------------------------------------------------------- shutdown


def test_close_drains_and_the_context_manager_too():
    target = MeanSquaredError(device=CPU)
    q = IngestQueue(target, capacity=16, start=False)
    for p, t in _batches(5, rows=8):
        q.enqueue(*_t(p, t.astype(np.float32)))
    q.close(drain=True)
    assert target._update_count == 5 and q not in active_queues()
    with pytest.raises(RuntimeError, match="closed"):
        q.enqueue(torch.ones(4), torch.zeros(4))
    with IngestQueue(MeanSquaredError(device=CPU), capacity=16, start=False) as q:
        for p, t in _batches(3, rows=8):
            q.enqueue(*_t(p, t.astype(np.float32)))
    assert q.target._update_count == 3


def test_close_without_drain_counts_every_pending_batch():
    target = MeanSquaredError(device=CPU)
    q = IngestQueue(target, capacity=16, start=False)
    for p, t in _batches(5, rows=8):
        q.enqueue(*_t(p, t.astype(np.float32)))
    q.close(drain=False)
    assert target._update_count == 0 and q.stats["dropped"] == 5


# -------------------------------------------------------------- checkpoint


def test_save_checkpoint_flushes_the_queue_first(tmp_path):
    batches = _batches(6, rows=8)
    sync = canonical_collection(True, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    target = canonical_collection(True, device=CPU)
    with IngestQueue(target, capacity=16, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t))
        assert q.depth == 6
        target.save_checkpoint(str(tmp_path), step=0)
        assert q.depth == 0
    fresh = canonical_collection(True, device=CPU)
    fresh.restore_checkpoint(str(tmp_path))
    assert _bitwise(sync.compute(), fresh.compute())


def test_flush_for_and_max_queue_depth():
    t1, t2 = MeanSquaredError(device=CPU), MeanSquaredError(device=CPU)
    with IngestQueue(t1, capacity=16, start=False) as q1, IngestQueue(t2, capacity=16, start=False) as q2:
        for p, t in _batches(3, rows=8):
            q1.enqueue(*_t(p, t.astype(np.float32)))
        q2.enqueue(torch.ones(4), torch.zeros(4))
        assert max_queue_depth() == 3
        assert flush_for(t1) == 1 and q1.depth == 0 and q2.depth == 1
        assert flush_for(MeanSquaredError(device=CPU)) == 0
        assert q1.tick() == 0 and q2.tick(limit=1) == 1


# ------------------------------------------------------------------ faults


def test_enqueue_fault_is_typed_and_admits_nothing():
    with IngestQueue(MeanSquaredError(device=CPU), capacity=4, start=False) as q:
        with fault.FaultSchedule(fire_at={"ingest.enqueue": 0}) as sched:
            with pytest.raises(fault.InjectedFaultError):
                q.enqueue(torch.ones(4), torch.zeros(4))
        assert [e["site"] for e in sched.fired] == ["ingest.enqueue"] and q.depth == 0


def test_tick_fault_degrades_to_synchronous_updates_bit_equal():
    batches = _batches(5, rows=8)
    sync = canonical_collection(True, device=CPU)
    for p, t in batches:
        sync.update(*_t(p, t))
    with IngestQueue(canonical_collection(True, device=CPU), capacity=16, start=False) as q:
        for p, t in batches:
            q.enqueue(*_t(p, t))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with fault.FaultSchedule(fire_at={"ingest.tick": 0}):
                q.flush()
        assert q.stats["degrades"] == 1 and q.stats["launches"] == 0
        assert any("ingest.tick" in str(w.message) for w in caught)
        assert _bitwise(sync.compute(), q.compute())


def test_a_rejected_batch_is_stashed_and_the_rest_applied():
    target = MeanSquaredError(nan_policy="raise", device=CPU)
    with IngestQueue(target, capacity=8, start=False) as q:
        q.enqueue(torch.ones(4), torch.zeros(4))
        q.enqueue(torch.tensor([1.0, float("nan"), 0.0, 0.0]), torch.zeros(4))
        q.enqueue(torch.ones(4), torch.zeros(4))
        with pytest.raises(fault.PoisonedInputError):
            q.flush()
        assert target._update_count == 2 and q.stats["eager_entries"] == 3


def test_registry_counts_the_tier():
    with obs.observe(clear=True) as reg:
        with IngestQueue(MeanSquaredError(device=CPU), capacity=8, start=False) as q:
            for p, t in _batches(3, rows=8):
                q.enqueue(*_t(p, t.astype(np.float32)))
            q.flush()
        assert reg.get("ingest", "enqueued") == 3 and reg.get("ingest", "ticks") == 1
        assert reg.get("ingest", "launches") == 1 and reg.get("ingest", "coalesced_rows") == 24
    obs.REGISTRY.clear()
