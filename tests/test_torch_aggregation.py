"""Aggregators and metric arithmetic of metrics_tpu_torch against metrics_tpu, on the CPU.

The same seeded numpy streams go through ``MaxMetric``, ``MinMetric``, ``SumMetric``,
``CatMetric`` and ``MeanMetric`` of both packages under every ``nan_strategy``
(``error``, ``warn``, ``ignore`` and a float), by ``update`` and by ``forward``; then
``CompositionalMetric`` trees built by the operators, binary, reflected and unary,
over aggregators and classification metrics. Both packages compute in float32:
values agree within rtol 1e-6, atol 1e-6.
"""
import operator
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.core.aggregation as ja
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.core.aggregation as ta
from metrics_tpu_torch.core import CompositionalMetric
from tests.torch_deadline import deadline  # noqa: F401

AGGREGATORS = ["MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]


def assert_close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


def stream(seed, nans):
    rng = np.random.RandomState(seed)
    values = [rng.randn(7).astype(np.float32), np.float32(rng.randn()), rng.randn(6).astype(np.float32)]
    if nans:
        values[0][[1, 4]] = np.nan
        values[2][3] = np.nan
    return values


@pytest.mark.parametrize("nans", [False, True])
@pytest.mark.parametrize("nan_strategy", ["error", "warn", "ignore", 2.0])
@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_update_matches_jax(name, nan_strategy, nans):
    jm, tm = getattr(ja, name)(nan_strategy=nan_strategy), getattr(ta, name)(nan_strategy=nan_strategy, device="cpu")
    values = stream(0, nans)
    if nans and nan_strategy == "error":
        with pytest.raises(RuntimeError, match="nan"):
            jm.update(jnp.asarray(values[0]))
        with pytest.raises(RuntimeError, match="nan"):
            tm.update(values[0])
        return
    for v in values:
        if nan_strategy == "warn" and np.isnan(v).any():
            with pytest.warns(UserWarning, match="nan"):
                tm.update(v)
        else:
            tm.update(v)
        jm.update(jnp.asarray(v))
    assert_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_forward_matches_jax(name):
    jm, tm = getattr(ja, name)(nan_strategy="ignore"), getattr(ta, name)(nan_strategy="ignore", device="cpu")
    for v in stream(1, nans=True):
        assert_close(tm(v), jm(jnp.asarray(v)))
    assert_close(tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    tm.update(np.float32(3.5))
    jm.update(jnp.asarray(3.5))
    assert_close(tm.compute(), jm.compute())


def test_mean_metric_weights():
    rng = np.random.RandomState(2)
    jm, tm = ja.MeanMetric(), ta.MeanMetric(device="cpu")
    for _ in range(3):
        v, w = rng.randn(5).astype(np.float32), rng.rand(5).astype(np.float32)
        tm.update(v, w)
        jm.update(jnp.asarray(v), jnp.asarray(w))
    tm.update(np.float32(1.5), np.float32(4.0))  # a scalar weight broadcasts
    jm.update(jnp.asarray(1.5), jnp.asarray(4.0))
    assert_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("nan_strategy", ["ignore", "warn"])
def test_weighted_mean_with_nan_values_raises_value_error_in_both(nan_strategy):
    """Both packages drop the NaN values but not their weights: the weights no longer
    broadcast, and both raise ``ValueError``."""
    v = np.array([1.0, np.nan, 3.0, 4.0], np.float32)
    w = np.array([0.5, 1.0, 2.0, 1.0], np.float32)
    jm, tm = ja.MeanMetric(nan_strategy=nan_strategy), ta.MeanMetric(nan_strategy=nan_strategy, device="cpu")
    errors = []
    for update, args in ((jm.update, (jnp.asarray(v), jnp.asarray(w))), (tm.update, (v, w))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "warn" announces the dropped NaN
            with pytest.raises(ValueError, match="Incompatible shapes for broadcasting") as err:
                update(*args)
        errors.append(err.type)
    assert errors[0] is errors[1] is ValueError


def test_aggregator_arguments():
    with pytest.raises(ValueError, match="nan_strategy"):
        ta.SumMetric(nan_strategy="drop", device="cpu")
    m = ta.CatMetric(device="cpu")
    m.update(np.array([np.nan], np.float32))  # the default "warn" drops it: nothing is appended
    assert m.value == []
    assert ta.MeanMetric(device="cpu").value.device.type == "cpu"


# ------------------------------------------------------------------ arithmetic


def two_sums(pkg, device):
    kw = {} if device is None else {"device": device}
    a, b = getattr(pkg, "SumMetric")(**kw), getattr(pkg, "SumMetric")(**kw)
    return a, b


def feed(pair, torch_side, a_values=(2.0, 3.0), b_values=(1.5, 0.25)):
    for m, vals in zip(pair, (a_values, b_values)):
        for v in vals:
            m.update(np.float32(v) if torch_side else jnp.asarray(v, jnp.float32))


BINARY_OPS = [
    operator.add, operator.sub, operator.mul, operator.truediv, operator.floordiv, operator.mod, operator.pow,
    operator.lt, operator.le, operator.gt, operator.ge, operator.eq, operator.ne,
]


@pytest.mark.parametrize("op", BINARY_OPS, ids=lambda op: op.__name__)
@pytest.mark.parametrize("form", ["metric_metric", "metric_number", "number_metric"])
def test_binary_operators_match_jax(op, form):
    results = []
    for pkg, device in ((ja, None), (ta, "cpu")):
        a, b = two_sums(pkg, device)
        if form == "metric_metric":
            composed = op(a, b)
        elif form == "metric_number":
            composed = op(a, 2.0)
        else:
            composed = op(3.0, a)
        assert type(composed).__name__ == "CompositionalMetric"
        feed((a, b), torch_side=device is not None)
        results.append(composed.compute())
    assert_close(results[1], results[0])


@pytest.mark.parametrize("op", [abs, operator.neg, operator.pos], ids=["abs", "neg", "pos"])
def test_unary_operators_match_jax(op):
    results = []
    for pkg, device in ((ja, None), (ta, "cpu")):
        a, b = two_sums(pkg, device)
        composed = op(a - b)
        feed((a, b), torch_side=device is not None, b_values=(9.0,))
        results.append(composed.compute())
    assert_close(results[1], results[0])


def test_indexing_and_bitwise_operators_match_jax():
    results = []
    for pkg, device in ((ja, None), (ta, "cpu")):
        kw = {} if device is None else {"device": device}
        cat = pkg.CatMetric(**kw)
        a, b = two_sums(pkg, device)
        second, flags = cat[1], ~((a > b) & (a < 100.0)) | ((a >= b) ^ (b <= 0.0))
        for v in (1.0, 2.0, 3.0):
            cat.update(np.float32(v) if device else jnp.asarray(v, jnp.float32))
        feed((a, b), torch_side=device is not None)
        results.append((second.compute(), flags.compute()))
    for got, want in zip(results[1], results[0]):
        assert_close(got, want)


def test_f1_from_precision_and_recall_equals_f1_score():
    rng = np.random.RandomState(3)
    p, r = tc.BinaryPrecision(device="cpu"), tc.BinaryRecall(device="cpu")
    f1 = tc.BinaryF1Score(device="cpu")
    composed = 2 * (p * r) / (p + r)
    jp, jr = jc.BinaryPrecision(), jc.BinaryRecall()
    jcomposed = 2 * (jp * jr) / (jp + jr)
    for _ in range(3):
        preds, target = rng.rand(32).astype(np.float32), rng.randint(0, 2, 32)
        batch = composed(preds, target)
        jbatch = jcomposed(jnp.asarray(preds), jnp.asarray(target))
        assert_close(batch, jbatch)
        f1.update(preds, target)
    assert_close(composed.compute(), f1.compute())
    assert_close(composed.compute(), jcomposed.compute())
    composed.reset()
    assert p._update_count == 0 and r._update_count == 0


def test_composition_update_filters_keyword_arguments():
    rng = np.random.RandomState(4)
    mean, total = ta.MeanMetric(device="cpu"), ta.SumMetric(device="cpu")
    composed = mean + total
    v, w = rng.rand(4).astype(np.float32), rng.rand(4).astype(np.float32)
    composed.update(v, weight=w)  # SumMetric.update takes no ``weight``
    want = float((v * w).sum() / w.sum() + v.sum())
    assert abs(float(composed.compute()) - want) < 1e-5
    assert isinstance(composed, CompositionalMetric) and composed.device.type == "cpu"
    assert composed.metric_b is total


def test_composition_takes_its_operand_device_and_refuses_iteration():
    a = ta.SumMetric(device="cpu")
    composed = 1 + a
    assert composed.metric_a.device.type == "cpu" and composed.device.type == "cpu"
    with pytest.raises(NotImplementedError):
        iter(a)
