"""The port's ``CatBuffer`` and ``cat_capacity`` states against metrics_tpu, on the CPU.

Buffer fields (``data``, ``count``, ``overflow``, ``values()``, ``mask()``,
``valid_count()``) are held bit for bit against ``metrics_tpu.core.state.CatBuffer``
after the same appends, overflow included (the newest append overwrites the tail,
the flag sticks). A ``cat_capacity`` retrieval metric equals its list-state twin
bit for bit; a JAX ``RetrievalMAP(cat_capacity=...)`` state loaded with
``load_jax_state`` computes the JAX value (rtol 1e-6: the JAX package feeds the
near-full buffer, padding rows and all, to its float scans, the port the valid
rows); ``merge_state`` refuses ``CatBuffer`` states as the JAX package does.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.core import state as jstate
from metrics_tpu.retrieval import RetrievalMAP as JRetrievalMAP
from metrics_tpu.utils.exceptions import MetricsUserError as JMetricsUserError
from metrics_tpu_torch import retrieval as tr
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core.state import CatBuffer, cat_merge, cat_values, is_cat_buffer
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.torch_deadline import deadline  # noqa: F401

_rng = np.random.RandomState(29)

# (capacity, item_shape, numpy dtype, fill, the row counts appended in turn)
SEQUENCES = {
    "fits": (16, (), np.float32, 0, [3, 1, 5, 0, 2]),
    "exactly_full": (10, (), np.int32, -1, [4, 6]),
    "overflow_tail": (8, (), np.int32, -1, [5, 2, 3, 1]),
    "one_append_past_capacity": (6, (), np.float32, 0, [2, 9]),
    "rows_of_three": (7, (3,), np.float32, 0.5, [2, 1, 3, 4]),
    "scalar_rows": (5, (), np.int32, 7, [0, 0, 1]),
}


def _rows(count, item_shape, dtype):
    rows = (_rng.randn(count, *item_shape) * 10).astype(dtype)
    return rows


def _buffers(name):
    """The same appends into a JAX and a port buffer; 0 appends a single scalar row."""
    capacity, item_shape, dtype, fill, counts = SEQUENCES[name]
    j = jstate.CatBuffer.create(capacity, item_shape, jnp.dtype(dtype), fill)
    t = CatBuffer.create(capacity, item_shape, torch.from_numpy(np.zeros(0, dtype)).dtype, fill)
    for count in counts:
        rows = _rows(1, item_shape, dtype)[0] if count == 0 else _rows(count, item_shape, dtype)
        j.append(jnp.asarray(rows))
        t.append(torch.from_numpy(np.asarray(rows)))
    return j, t


def _assert_same(j, t):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert int(t.count) == int(j.count) and t.count.dtype == torch.int32
    assert bool(t.overflow) == bool(j.overflow)
    assert t.valid_count() == int(j.valid_count())
    assert t.overflowed() == bool(j.overflowed())
    np.testing.assert_array_equal(t.mask().numpy(), np.asarray(j.mask()))
    assert t.capacity == j.capacity and len(t) == len(j)


@pytest.mark.parametrize("name", SEQUENCES)
def test_appends_match_jax(name):
    j, t = _buffers(name)
    _assert_same(j, t)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = np.asarray(j.values())
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t.values().numpy()
    np.testing.assert_array_equal(got, want)
    assert len(tw) == len(jw) == int(j.overflowed())


def test_overflow_overwrites_the_tail_and_sticks():
    t = CatBuffer.create(4, dtype=torch.int32, fill_value=-1)
    t.append(torch.tensor([1, 2, 3]))
    t.append(torch.tensor([4, 5]))  # writes at clip(3, 0, 4 - 2) = 2
    assert t.data.tolist() == [1, 2, 4, 5] and int(t.count) == 5 and t.overflowed()
    merged = cat_merge(CatBuffer.create(8, dtype=torch.int32), t)
    assert merged.overflowed() and bool(merged.overflow) and int(merged.count) == 4
    with pytest.warns(RuntimeWarning, match="overflow"):
        merged.values()


def test_extend_cast_and_helpers_match_jax():
    j = jstate.CatBuffer.create(6, dtype=jnp.int32)
    t = CatBuffer.create(6, dtype=torch.int32)
    parts = [np.array([1.9, -2.1]), np.array([3.5]), np.array([7.0, 8.2])]
    j.extend([jnp.asarray(p) for p in parts])
    t.extend([torch.tensor(p) for p in parts])
    _assert_same(j, t)
    assert is_cat_buffer(t) and not is_cat_buffer(t.data)
    np.testing.assert_array_equal(cat_values(t).numpy(), np.asarray(jstate.cat_values(j)))
    np.testing.assert_array_equal(
        cat_values([torch.tensor([1, 2]), torch.tensor(3)]).numpy(),
        np.asarray(jstate.cat_values([jnp.asarray([1, 2]), jnp.asarray(3)])),
    )
    jm, tm = jstate.cat_merge(j, j), cat_merge(t, t)
    _assert_same(jm, tm)
    assert int(t.count) == 5  # cat_merge leaves its inputs alone
    host, jhost = t.to_host(), j.to_host()
    assert host["count"] == jhost["count"] and host["overflow"] == jhost["overflow"]
    np.testing.assert_array_equal(host["data"], jhost["data"])
    rows = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    _assert_same(jstate.CatBuffer.from_rows(rows, 5, fill_value=-1.0), CatBuffer.from_rows(rows, 5, fill_value=-1.0))
    with pytest.raises(ValueError, match="do not fit"):
        CatBuffer.from_rows(rows, 1)


def test_clone_is_independent():
    t = CatBuffer.create(4)
    t.append(torch.tensor([1.0]))
    c = t.clone()
    c.append(torch.tensor([2.0, 3.0]))
    assert int(t.count) == 1 and t.data.tolist() == [1.0, 0.0, 0.0, 0.0]
    assert int(c.count) == 3


def _retrieval_data(n=900, queries=80, seed=3):
    rng = np.random.RandomState(seed)
    indexes = rng.randint(0, queries, n)
    preds = torch.tensor(rng.randn(n), dtype=torch.float32).to(torch.bfloat16).to(torch.float32).numpy()
    target = (rng.rand(n) < 0.2).astype(np.int64)
    return np.array_split(np.arange(n), 6), indexes, preds, target


@pytest.mark.parametrize("capacity", [900, 1200, 4096])
@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalRPrecision"])
def test_cat_capacity_metric_equals_list_twin(name, capacity):
    """900 rows: a full buffer (the whole-buffer path), and two partly filled ones."""
    parts, indexes, preds, target = _retrieval_data()
    listed = getattr(tr, name)(device="cpu")
    buffered = getattr(tr, name)(device="cpu", cat_capacity=capacity)
    for part in parts:
        for m in (listed, buffered):
            m.update(torch.tensor(preds[part]), torch.tensor(target[part]), indexes=torch.tensor(indexes[part]))
    buf = buffered.indexes
    assert isinstance(buf, CatBuffer) and buf.capacity == capacity and buf.data.dtype == torch.int32
    assert torch.equal(buf.data[:900], torch.tensor(indexes, dtype=torch.int32)) and bool((buf.data[900:] == -1).all())
    assert torch.equal(buffered.compute(), listed.compute())


def test_load_jax_catbuffer_state_computes_the_same():
    parts, indexes, preds, target = _retrieval_data()
    jm = JRetrievalMAP(cat_capacity=1024)
    for part in parts:
        jm.update(jnp.asarray(preds[part]), jnp.asarray(target[part]), indexes=jnp.asarray(indexes[part]))
    jm.persistent(True)
    state = jm.state_dict()
    assert set(state["indexes"]) == {"data", "count", "overflow"}
    tm = load_jax_state(tr.RetrievalMAP(device="cpu", cat_capacity=1024), state)
    for key in ("indexes", "preds", "target"):
        buf = getattr(tm, key)
        assert isinstance(buf, CatBuffer)
        np.testing.assert_array_equal(buf.data.numpy(), state[key]["data"])
        assert int(buf.count) == int(state[key]["count"]) and bool(buf.overflow) == bool(state[key]["overflow"])
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=1e-6)
    # into a list-state metric the buffer arrives as a buffer too
    tl = load_jax_state(tr.RetrievalMAP(device="cpu"), state)
    assert isinstance(tl.indexes, CatBuffer) and torch.equal(tl.compute(), tm.compute())


def test_merge_state_refuses_catbuffers_as_jax_does():
    jm, jo = JRetrievalMAP(cat_capacity=64), JRetrievalMAP(cat_capacity=64)
    tm, to = tr.RetrievalMAP(cat_capacity=64, device="cpu"), tr.RetrievalMAP(cat_capacity=64, device="cpu")
    to.update(torch.rand(3), torch.tensor([0, 1, 1]), indexes=torch.tensor([0, 0, 1]))
    with pytest.raises(JMetricsUserError, match="`indexes` is a CatBuffer state"):
        jm.merge_state(jo)
    with pytest.raises(MetricsUserError, match="`indexes` is a CatBuffer state"):
        tm.merge_state(to)
    with pytest.raises(MetricsUserError, match="is a CatBuffer state"):
        tr.RetrievalMAP(device="cpu").merge_state(to)


def test_catbuffer_state_dict_reset_to_and_forward():
    parts, indexes, preds, target = _retrieval_data(n=300)
    m = tr.RetrievalMAP(device="cpu", cat_capacity=512)
    twin = tr.RetrievalMAP(device="cpu")
    for part in parts:  # forward: reduce-state mode merges the batch buffer with cat_merge
        args = (torch.tensor(preds[part]), torch.tensor(target[part]))
        batch_value = m(*args, indexes=torch.tensor(indexes[part]))
        assert torch.equal(batch_value, twin(*args, indexes=torch.tensor(indexes[part])))
    assert int(m.indexes.count) == 300 and torch.equal(m.compute(), twin.compute())
    m.persistent(True)
    sd = m.state_dict()
    assert set(sd["indexes"]) == {"data", "count", "overflow"} and int(sd["preds"]["count"]) == 300
    fresh = tr.RetrievalMAP(device="cpu", cat_capacity=512)
    fresh.load_state_dict(sd)
    assert torch.equal(fresh.compute(), twin.compute())
    moved = fresh.to("cpu")
    assert isinstance(moved.indexes, CatBuffer) and moved.indexes.valid_count() == 300
    fresh.reset()
    assert int(fresh.indexes.count) == 0 and bool((fresh.indexes.data == -1).all())
    assert int(m.indexes.count) == 300  # reset gave the other metric nothing of its own


def test_compute_warns_on_overflow_and_keeps_newest_rows():
    m = tr.RetrievalMAP(device="cpu", cat_capacity=8)
    m.update(torch.rand(6), torch.tensor([1, 0, 0, 1, 0, 1]), indexes=torch.tensor([0, 0, 0, 1, 1, 1]))
    m.update(torch.rand(4), torch.tensor([1, 0, 1, 0]), indexes=torch.tensor([2, 2, 3, 3]))
    assert m.indexes.data.tolist() == [0, 0, 0, 1, 2, 2, 3, 3]
    with pytest.warns(RuntimeWarning, match="overflowed its capacity 8"):
        value = m.compute()
    assert torch.isfinite(value)


def test_cat_capacity_argument_check():
    with pytest.raises(ValueError, match="cat_capacity"):
        tr.RetrievalMAP(device="cpu", cat_capacity=0)
    with pytest.raises(ValueError, match="cat_capacity"):
        tr.RetrievalMAP(device="cpu", cat_capacity=2.5)


@pytest.mark.parametrize("name,kwargs,preds_shape,target_high", [
    ("BinaryAUROC", {}, (), 2),
    ("BinaryAveragePrecision", {"ignore_index": -1}, (), 2),
    ("MulticlassAUROC", {"num_classes": 4}, (4,), 4),
    ("MultilabelAveragePrecision", {"num_labels": 3}, (3,), 2),
])
def test_cat_capacity_curves_equal_list_twin_and_jax(name, kwargs, preds_shape, target_high):
    """The exact curves' cat states declare their rows as the JAX package does."""
    from metrics_tpu import classification as jc
    from metrics_tpu_torch import classification as tc

    rng = np.random.RandomState(len(name))
    n = 1000
    preds = rng.rand(n, *preds_shape).astype(np.float32)
    target = rng.randint(0, target_high, (n, 3) if name.startswith("Multilabel") else n)
    if "ignore_index" in kwargs:
        target = np.where(rng.rand(n) < 0.1, -1, target)
    listed = getattr(tc, name)(device="cpu", **kwargs)
    buffered = getattr(tc, name)(device="cpu", cat_capacity=1500, **kwargs)
    jm = getattr(jc, name)(cat_capacity=1500, **kwargs)
    for part in np.array_split(np.arange(n), 4):
        for m in (listed, buffered):
            m.update(torch.tensor(preds[part]), torch.tensor(target[part]))
        jm.update(jnp.asarray(preds[part]), jnp.asarray(target[part]))
    assert buffered.preds.data.shape == (1500, *preds_shape) and buffered.target.data.dtype == torch.int32
    np.testing.assert_array_equal(buffered.preds.data.numpy(), np.asarray(jm.preds.data))
    assert torch.equal(buffered.compute(), listed.compute())
    np.testing.assert_allclose(buffered.compute().numpy(), np.asarray(jm.compute()), rtol=1e-6)
