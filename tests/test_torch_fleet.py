"""The fleet axis of metrics_tpu_torch (``core/fleet.py``) against metrics_tpu's, on the CPU.

The cases of the JAX package's fleet contract (``tests/unittests/bases/test_fleet.py``)
run in both packages on the same seeded numpy inputs: routed updates against
independent instances, broadcast, ``_fleet_rows``, an empty stream, float and max
routing, ``compute(stream=)``, ``reduce_fleet``, merges and every error. Integer
states and counts are bit-equal to the JAX fleet's; float values agree within rtol
1e-6 (the fold reorders sums). On the CPU the routed step runs eagerly under
``torch.func.vmap``, and its histograms take the batching rule's plain version.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.core.aggregation as ja
import metrics_tpu.core.collections as jcol
import metrics_tpu.regression as jreg
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.regression as treg
from metrics_tpu.core.fleet import ROWS_STATE as JAX_ROWS_STATE
from metrics_tpu.utils.exceptions import MetricsUserError as JaxMetricsUserError
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core import MaxMetric, MetricCollection
from metrics_tpu_torch.core.fleet import ROWS_STATE
from metrics_tpu_torch.utils.exceptions import MetricsUserError

CPU = {"device": "cpu"}


def _batches(num, rows, num_classes=3, fleet=4, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, num_classes, rows), rng.integers(0, num_classes, rows), rng.integers(0, fleet, rows).astype(np.int32))
        for _ in range(num)
    ]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _equal(port, jax_value):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(jax_value))


def test_fleet_state_shapes_match_jax():
    port = tc.MulticlassAccuracy(num_classes=5, average=None, fleet_size=3, **CPU)
    ref = jc.MulticlassAccuracy(num_classes=5, average=None, fleet_size=3)
    assert port.fleet_size == 3 and tuple(port.tp.shape) == tuple(ref.tp.shape) == (3, 5)
    assert tuple(getattr(port, ROWS_STATE).shape) == (3,) and getattr(port, ROWS_STATE).dtype == torch.int32
    assert ROWS_STATE == JAX_ROWS_STATE and port._reductions[ROWS_STATE] == "sum"
    assert list(port._defaults) == list(ref._defaults)


def test_as_fleet_replicates_live_state():
    base = tc.BinaryAccuracy(**CPU)
    base.update(_t([1, 0, 1]), _t([1, 1, 1]))
    fleet = base.as_fleet(2)
    assert fleet.fleet_size == 2 and base.fleet_size is None
    assert torch.equal(fleet.tp, base.tp.unsqueeze(0).repeat(2, 1))
    with pytest.raises(MetricsUserError, match="already"):
        tc.BinaryAccuracy(fleet_size=2, **CPU).as_fleet(3)


@pytest.mark.parametrize("bad", [0, -1, True, 2.5, "4"])
def test_bad_fleet_size(bad):
    with pytest.raises(ValueError, match="fleet_size"):
        tc.BinaryAccuracy(fleet_size=bad, **CPU)


def test_ineligible_states_rejected():
    from metrics_tpu_torch.regression import PearsonCorrCoef
    from metrics_tpu_torch.retrieval import RetrievalMAP

    with pytest.raises(MetricsUserError, match="list/cat state"):
        RetrievalMAP(fleet_size=2, **CPU)
    with pytest.raises(MetricsUserError, match="sum/max/min"):
        PearsonCorrCoef(fleet_size=2, **CPU)
    with pytest.raises(MetricsUserError, match="mutually exclusive"):
        RetrievalMAP(fleet_size=2, cat_capacity=16, **CPU)
    with pytest.raises(MetricsUserError, match="cannot become a fleet"):
        RetrievalMAP(**CPU).as_fleet(2)


@pytest.mark.parametrize("average", [None, "micro", "macro"])
def test_routed_bit_identical_to_independent_instances_and_to_jax(average):
    fleet = tc.MulticlassAccuracy(num_classes=3, average=average, fleet_size=4, **CPU)
    jfleet = jc.MulticlassAccuracy(num_classes=3, average=average, fleet_size=4)
    refs = [tc.MulticlassAccuracy(num_classes=3, average=average, **CPU) for _ in range(4)]
    for preds, target, ids in _batches(5, 64):
        fleet.update(_t(preds), _t(target), stream_ids=_t(ids))
        jfleet.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
        for s, ref in enumerate(refs):
            m = ids == s
            if m.any():
                ref.update(_t(preds[m]), _t(target[m]))
    out = fleet.compute()
    for name in ("tp", "fp", "tn", "fn", ROWS_STATE):
        _equal(getattr(fleet, name), getattr(jfleet, name))
    np.testing.assert_allclose(out.numpy(), np.asarray(jfleet.compute()), rtol=1e-6)
    for s, ref in enumerate(refs):
        assert torch.equal(out[s], ref.compute())
        assert torch.equal(fleet.compute(stream=s), ref.compute())


def test_broadcast_update_hits_every_stream():
    fleet = tc.BinaryAccuracy(fleet_size=3, **CPU)
    jfleet = jc.BinaryAccuracy(fleet_size=3)
    ref = tc.BinaryAccuracy(**CPU)
    preds, target = np.array([1, 0, 1, 1]), np.array([1, 1, 0, 1])
    fleet.update(_t(preds), _t(target))
    jfleet.update(jnp.asarray(preds), jnp.asarray(target))
    ref.update(_t(preds), _t(target))
    out = fleet.compute()
    assert tuple(out.shape) == (3,)
    assert all(torch.equal(out[s], ref.compute()) for s in range(3))
    _equal(getattr(fleet, ROWS_STATE), getattr(jfleet, JAX_ROWS_STATE))
    _equal(getattr(fleet, ROWS_STATE), np.full(3, 4))


def test_rows_state_counts_routed_rows():
    fleet = tc.BinaryAccuracy(fleet_size=3, **CPU)
    fleet.update(torch.ones(5, dtype=torch.int32), torch.ones(5, dtype=torch.int32), stream_ids=_t([0, 0, 2, 2, 2]))
    _equal(getattr(fleet, ROWS_STATE), [2, 0, 3])


def test_empty_stream_keeps_default_state():
    fleet = tc.MulticlassAccuracy(num_classes=3, average="micro", fleet_size=3, **CPU)
    preds, target, _ = _batches(1, 8)[0]
    fleet.update(_t(preds), _t(target), stream_ids=torch.zeros(8, dtype=torch.int32))
    ref = tc.MulticlassAccuracy(num_classes=3, average="micro", **CPU)
    ref.update(_t(preds), _t(target))
    assert torch.equal(fleet.compute(stream=0), ref.compute())
    assert int(fleet.tp[1:].sum()) == 0


def test_float_accumulators_route():
    fleet = treg.MeanSquaredError(fleet_size=2, **CPU)
    jfleet = jreg.MeanSquaredError(fleet_size=2)
    refs = [treg.MeanSquaredError(**CPU) for _ in range(2)]
    rng = np.random.default_rng(3)
    preds, target = rng.normal(size=32).astype(np.float32), rng.normal(size=32).astype(np.float32)
    ids = rng.integers(0, 2, 32).astype(np.int32)
    fleet.update(_t(preds), _t(target), stream_ids=_t(ids))
    jfleet.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
    for s, ref in enumerate(refs):
        ref.update(_t(preds[ids == s]), _t(target[ids == s]))
    out = fleet.compute()
    for s in range(2):
        np.testing.assert_allclose(out[s].numpy(), refs[s].compute().numpy(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfleet.compute()), rtol=1e-6)
    _equal(fleet.total, jfleet.total)


def test_max_reduction_routes():
    fleet = MaxMetric(fleet_size=3, **CPU)
    jfleet = ja.MaxMetric(fleet_size=3)
    vals, ids = np.array([1.0, 9.0, 4.0, 7.0], np.float32), np.array([0, 1, 1, 2], np.int32)
    fleet.update(_t(vals), stream_ids=_t(ids))
    jfleet.update(jnp.asarray(vals), stream_ids=jnp.asarray(ids))
    _equal(fleet.compute(), [1.0, 9.0, 7.0])
    _equal(fleet.compute(), jfleet.compute())
    empty = MaxMetric(fleet_size=2, **CPU)
    empty.update(_t(np.array([3.0], np.float32)), stream_ids=_t([1]))
    assert empty.value[0] == -float("inf") and empty.value[1] == 3.0


def test_compute_stream_errors_and_cache_indexing():
    m = tc.BinaryAccuracy(fleet_size=2, **CPU)
    m.update(_t([1, 0]), _t([1, 1]), stream_ids=_t([0, 1]))
    full = m.compute()
    assert torch.equal(m.compute(stream=1), full[1])
    with pytest.raises(MetricsUserError, match="stream"):
        m.compute(stream=2)
    plain = tc.BinaryAccuracy(**CPU)
    plain.update(_t([1, 1]), _t([1, 1]))
    with pytest.raises(MetricsUserError, match="fleet"):
        plain.compute(stream=0)
    with pytest.raises(MetricsUserError, match="fleet"):
        plain.reduce_fleet()


def test_reduce_fleet_matches_single_instance_and_jax():
    fleet = tc.MulticlassAccuracy(num_classes=3, average="micro", fleet_size=4, **CPU)
    jfleet = jc.MulticlassAccuracy(num_classes=3, average="micro", fleet_size=4)
    ref = tc.MulticlassAccuracy(num_classes=3, average="micro", **CPU)
    for preds, target, ids in _batches(3, 48):
        fleet.update(_t(preds), _t(target), stream_ids=_t(ids))
        jfleet.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
        ref.update(_t(preds), _t(target))
    assert torch.equal(fleet.reduce_fleet(), ref.compute())
    _equal(fleet.reduce_fleet(), jfleet.reduce_fleet())


def test_reset_restores_fleet_defaults():
    fleet = tc.BinaryAccuracy(fleet_size=3, **CPU)
    fleet.update(torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32))
    fleet.reset()
    assert tuple(fleet.tp.shape) == (3, 1) and int(fleet.tp.sum()) == 0
    assert int(getattr(fleet, ROWS_STATE).sum()) == 0


def test_stream_id_errors_match_jax():
    fleet = tc.BinaryAccuracy(fleet_size=2, **CPU)
    jfleet = jc.BinaryAccuracy(fleet_size=2)
    ones = np.ones(3, np.int32)
    cases = [(np.array([0, 1, 2], np.int32), r"\[0, 2\)"), (np.zeros((3, 1), np.int32), "1-D"),
             (np.zeros(2, np.int32), "entries but the batch has 3 rows"), (np.zeros(3, np.float32), "integer")]
    for ids, match in cases:
        with pytest.raises(MetricsUserError, match=match):
            fleet.update(_t(ones), _t(ones), stream_ids=_t(ids))
        with pytest.raises(JaxMetricsUserError, match=match):
            jfleet.update(jnp.asarray(ones), jnp.asarray(ones), stream_ids=jnp.asarray(ids))


def test_stream_ids_reach_fleet_members_only_in_a_collection():
    col = MetricCollection({"fleet": tc.BinaryAccuracy(fleet_size=2, **CPU), "plain": tc.BinaryAccuracy(**CPU)})
    ones = torch.ones(4, dtype=torch.int32)
    col.update(ones, ones, stream_ids=_t([0, 1, 0, 1]))
    out = col.compute()
    assert tuple(out["fleet"].shape) == (2,) and tuple(out["plain"].shape) == ()


def test_merges():
    a, b, c = (tc.BinaryAccuracy(fleet_size=n, **CPU) for n in (2, 3, 2))
    with pytest.raises(MetricsUserError, match="fleet sizes differ"):
        a.merge_state(b)
    with pytest.raises(MetricsUserError, match="fleet sizes differ"):
        a.merge_state(tc.BinaryAccuracy(**CPU))
    ids = _t([0, 1])
    a.update(_t([1, 0]), _t([1, 1]), stream_ids=ids)
    c.update(_t([1, 1]), _t([1, 0]), stream_ids=ids)
    ref = tc.BinaryAccuracy(fleet_size=2, **CPU)
    ref.update(_t([1, 0]), _t([1, 1]), stream_ids=ids)
    ref.update(_t([1, 1]), _t([1, 0]), stream_ids=ids)
    a.merge_state(c)
    assert torch.equal(a.compute(), ref.compute())


def test_fleet_forward_clone_and_pickle():
    fleet = tc.BinaryAccuracy(fleet_size=2, **CPU)
    batch = fleet(_t([1, 0, 1]), _t([1, 1, 1]), stream_ids=_t([0, 1, 1]))
    assert tuple(batch.shape) == (2,)
    clone = pickle.loads(pickle.dumps(fleet.clone()))
    for m in (fleet, clone):
        m.update(_t([0, 0]), _t([0, 1]), stream_ids=_t([1, 1]))
    assert torch.equal(fleet.compute(), clone.compute())


def test_vmapped_compute_falls_back_to_a_loop_where_compute_reads_the_host():
    class HostCompute(treg.MeanSquaredError):
        def compute(self):
            return torch.tensor(float(self.sum_squared_error) / max(int(self.total), 1))

    fleet = HostCompute(fleet_size=3, **CPU)
    fleet.update(_t(np.ones(4, np.float32)), _t(np.zeros(4, np.float32)), stream_ids=_t([0, 0, 2, 2]))
    _equal(fleet.compute(), [1.0, 0.0, 1.0])


def test_load_jax_state_of_a_fleet():
    jfleet = jc.MulticlassAccuracy(num_classes=3, average=None, fleet_size=4)
    for preds, target, ids in _batches(2, 40):
        jfleet.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
    jfleet.persistent(True)
    port = load_jax_state(tc.MulticlassAccuracy(num_classes=3, average=None, fleet_size=4, **CPU),
                          jfleet.state_dict())
    _equal(getattr(port, ROWS_STATE), getattr(jfleet, JAX_ROWS_STATE))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(jfleet.compute()), rtol=1e-6)
    preds, target, ids = _batches(1, 40, seed=5)[0]
    port.update(_t(preds), _t(target), stream_ids=_t(ids))
    jfleet.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
    _equal(port.tp, jfleet.tp)


def test_fleet_in_a_jax_collection_and_port_collection_agree():
    jcoll = jcol.MetricCollection({"acc": jc.MulticlassAccuracy(num_classes=3, fleet_size=4)})
    coll = MetricCollection({"acc": tc.MulticlassAccuracy(num_classes=3, fleet_size=4, **CPU)})
    for preds, target, ids in _batches(2, 32):
        jcoll.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
        coll.update(_t(preds), _t(target), stream_ids=_t(ids))
    np.testing.assert_allclose(coll.compute()["acc"].numpy(), np.asarray(jcoll.compute()["acc"]), rtol=1e-6)


def test_fleet_steps_keep_their_state_structure():
    # a captured step copies its new state into buffers laid out like the old one
    from metrics_tpu_torch.core.fleet import broadcast_new_state, routed_new_state

    fleet = MaxMetric(fleet_size=3, **CPU)
    state = {name: getattr(fleet, name) for name in fleet._defaults}
    raw = type(fleet).update.__get__(fleet)
    values = _t(np.array([1.0, 2.0], np.float32))
    assert list(broadcast_new_state(fleet, raw, state, (values,), {})) == list(state)
    assert list(routed_new_state(fleet, raw, state, (values,), {}, _t([0, 2]))) == list(state)
