"""The exact curves' traced branches of metrics_tpu_torch against metrics_tpu, on the CPU.

- The static-shape curves (``binary_precision_recall_curve_padded``,
  ``binary_roc_curve_padded``) bit-equal to the JAX package's, whole arrays with their
  NaN pads and K: ties, ``ignore_index`` masks, one class only, n = 1 and 2. Inside
  ``tracing()`` and under ``torch.func.vmap`` over a stack, each row equals its own
  unbatched call.
- The scan's vmap rule (``metrics_tpu_torch::segment_scan``): a vmapped
  ``segment_multi_scan`` equals per-row calls, for each op and ``reverse``, with and
  without the caller's flags, nested.
- Each traced branch against its JAX counterpart under ``jit``: the binary,
  multiclass and multilabel PR curve and ROC computes, the classes'
  ``_exact_cat_state`` over ``cat_capacity`` buffers, the fixed points, the nominal
  classes' NaN handling, and retrieval's dense buffer.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.nominal as jn
import metrics_tpu.retrieval as jr
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.nominal as tn
import metrics_tpu_torch.retrieval as tr
from metrics_tpu.ops import clf_curve as jcc
from metrics_tpu_torch.ops import clf_curve as cc
from metrics_tpu_torch.ops import rank
from metrics_tpu_torch.ops.segment import segment_multi_scan
from metrics_tpu_torch.utils.checks import tracing
from tests.torch_deadline import deadline  # noqa: F401

# the modules, which the packages' functions of the same names hide
jprc = importlib.import_module("metrics_tpu.functional.classification.precision_recall_curve")
jroc = importlib.import_module("metrics_tpu.functional.classification.roc")
tprc = importlib.import_module("metrics_tpu_torch.functional.classification.precision_recall_curve")
troc = importlib.import_module("metrics_tpu_torch.functional.classification.roc")
CPU = {"device": "cpu"}
CURVES = {"pr": (cc.binary_precision_recall_curve_padded, jcc.binary_precision_recall_curve_padded),
          "roc": (cc.binary_roc_curve_padded, jcc.binary_roc_curve_padded)}


def same(got, want) -> None:
    """Bit-equal arrays (NaN where NaN), dtypes aside."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.float64), want.astype(np.float64), equal_nan=True), (got, want)


def binary_case(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = {"n1": 1, "n2": 2}.get(kind, 37)
    preds = (np.round(rng.random(n) * 8) / 8).astype(np.float32)  # ties
    target = rng.integers(0, 2, n)
    if kind == "allpos":
        target[:] = 1
    elif kind == "allneg":
        target[:] = 0
    elif kind == "ignore":
        target[rng.random(n) < 0.3] = -1
    return preds, target


@pytest.mark.parametrize("curve", ["pr", "roc"])
@pytest.mark.parametrize("kind", ["ties", "ignore", "allpos", "allneg", "n1", "n2"])
def test_padded_curves_bit_equal_to_jax(curve, kind):
    port, jax_fn = CURVES[curve]
    preds, target = binary_case(kind)
    got = port(torch.tensor(preds), torch.tensor(target))
    want = jax_fn(jnp.asarray(preds), jnp.asarray(target))
    for g, w in zip(got, want):
        same(g, w)
    assert got[3].dtype == torch.int32
    with tracing():  # a traced call is the same call
        for g, w in zip(port(torch.tensor(preds), torch.tensor(target)), want):
            same(g, w)


@pytest.mark.parametrize("curve", ["pr", "roc"])
def test_padded_curves_under_vmap_equal_their_rows(curve):
    port, _ = CURVES[curve]
    rows = [binary_case(kind, seed) for seed, kind in enumerate(["ties", "ignore", "allpos", "allneg", "ties"])]
    preds = torch.tensor(np.stack([p for p, _ in rows]))
    target = torch.tensor(np.stack([t for _, t in rows]))
    for tier in ("sort", "rank"):
        with rank.force_tier(tier):
            batched = torch.func.vmap(port)(preds, target)
            for i in range(len(rows)):
                for b, one in zip(batched, port(preds[i], target[i])):
                    same(b[i], one)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ops", [("sum",), ("min", "max"), ("max", "sum", "min"), ("sum", "min", "max", "sum", "min")])
@pytest.mark.parametrize("flags", [None, "batched", "shared"])
def test_scan_vmap_rule_equals_per_row_calls(reverse, ops, flags):
    g = torch.Generator().manual_seed(len(ops) + 10 * reverse)
    b, n = 4, 29
    lanes = [torch.randint(-50, 50, (b, n), generator=g, dtype=dtype)
             for dtype in (torch.int32, torch.int64, torch.int16, torch.int32, torch.int8)[:len(ops)]]
    f = {"batched": torch.rand((b, n), generator=g) < 0.2, "shared": torch.rand(n, generator=g) < 0.2}.get(flags)

    def scan(*ls, fl=None):
        return segment_multi_scan(ls, fl, ops=ops, reverse=reverse)

    if flags == "batched":
        got = torch.func.vmap(lambda fl, *ls: scan(*ls, fl=fl))(f, *lanes)
    else:
        got = torch.func.vmap(lambda *ls: scan(*ls, fl=f))(*lanes)
    for i in range(b):
        row_flags = f[i] if flags == "batched" else f
        for got_lane, want in zip(got, scan(*(lane[i] for lane in lanes), fl=row_flags)):
            assert got_lane.dtype == want.dtype and torch.equal(got_lane[i], want)


def test_scan_vmap_rule_nested():
    vals = torch.randint(0, 9, (2, 3, 11), generator=torch.Generator().manual_seed(1))
    f = torch.tensor([True, False, False, True] + [False] * 7)
    got = torch.func.vmap(torch.func.vmap(lambda v: segment_multi_scan([v], f, ops=("sum",), reverse=True)[0]))(vals)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], segment_multi_scan([vals[i, j]], f, ops=("sum",), reverse=True)[0])


def test_select_tier_reads_the_per_sample_size():
    seen = []

    def probe(x):
        seen.append((x.numel(), rank.select_tier(x)))
        return x

    torch.func.vmap(probe)(torch.zeros(8, 5))
    assert seen == [(5, "sort")]


# ------------------------------------------------------------ traced branches


@pytest.mark.parametrize("kind", ["ties", "ignore", "allneg"])
@pytest.mark.parametrize("pos_label", [1, 0])
def test_binary_traced_branches_match_jax_jit(kind, pos_label):
    preds, target = binary_case(kind, 3)
    for port_fn, jax_fn in ((tprc._binary_precision_recall_curve_compute, jprc._binary_precision_recall_curve_compute),
                            (troc._binary_roc_compute, jroc._binary_roc_compute)):
        want = jax.jit(lambda p, t: jax_fn((p, t), None, pos_label))(jnp.asarray(preds), jnp.asarray(target))
        with tracing():
            got = port_fn((torch.tensor(preds), torch.tensor(target)), None, pos_label)
        for g, w in zip(got, want):
            same(g, w)


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_per_column_traced_branches_match_jax_jit(task):
    rng = np.random.default_rng(4)
    n, c = 23, 3
    preds = (np.round(rng.random((n, c)) * 6) / 6).astype(np.float32)
    target = rng.integers(0, c, n) if task == "multiclass" else rng.integers(0, 2, (n, c))
    target[rng.random(target.shape) < 0.2] = -1
    pairs = {"multiclass": ((tprc._multiclass_precision_recall_curve_compute,
                             jprc._multiclass_precision_recall_curve_compute),
                            (troc._multiclass_roc_compute, jroc._multiclass_roc_compute)),
             "multilabel": ((tprc._multilabel_precision_recall_curve_compute,
                             jprc._multilabel_precision_recall_curve_compute),
                            (troc._multilabel_roc_compute, jroc._multilabel_roc_compute))}[task]
    for port_fn, jax_fn in pairs:
        want = jax.jit(lambda p, t: jax_fn((p, t), c, None))(jnp.asarray(preds), jnp.asarray(target))
        with tracing():
            got = port_fn((torch.tensor(preds), torch.tensor(target)), c, None)
        for g, w in zip(got, want):
            same(g, w)
        # under vmap too: one batched sort and one scan over the columns
        batched = torch.func.vmap(lambda p: port_fn((p, torch.tensor(target)), c, None))(torch.tensor(preds)[None])
        for g, w in zip(batched, want):
            same(g[0], w)


def buffered(jax_metric, port_metric, batches):
    """Eager updates of both metrics, then the JAX ``compute_from`` under ``jit`` and the
    port's inside ``tracing()`` (the traced branch of ``_exact_cat_state``)."""
    js, ts = jax_metric.init_state(), port_metric.init_state()
    for batch in batches:
        js = jax_metric.local_update(js, *(jnp.asarray(x) for x in batch))
        ts = port_metric.local_update(ts, *(torch.tensor(x) for x in batch))
    want = jax.jit(jax_metric.compute_from)(js)
    with tracing():
        got = port_metric.compute_from(ts)
    return got, want, port_metric.compute_from(ts)


@pytest.mark.parametrize("name", ["BinaryPrecisionRecallCurve", "BinaryROC"])
def test_exact_cat_state_curves_match_jax_jit(name):
    batches = [binary_case("ignore", s) for s in range(2)]
    got, want, eager = buffered(getattr(jc, name)(cat_capacity=128, ignore_index=-1),
                                getattr(tc, name)(cat_capacity=128, ignore_index=-1, **CPU), batches)
    for g, w in zip(got, want):
        same(g, w)
    k = int((~torch.isnan(got[2])).sum())
    for g, e in zip(got, eager):  # the first K entries are the eager curve
        same(g[:k], e[:k])


@pytest.mark.parametrize("name, bound", [("BinaryRecallAtFixedPrecision", 0.6),
                                         ("BinarySpecificityAtSensitivity", 0.5),
                                         ("BinaryPrecisionAtFixedRecall", 0.5)])
def test_fixed_points_traced_match_jax_jit(name, bound):
    batches = [binary_case("ties", s) for s in range(3)]
    got, want, eager = buffered(getattr(jc, name)(bound, cat_capacity=256), getattr(tc, name)(bound, cat_capacity=256,
                                                                                              **CPU), batches)
    for g, w, e in zip(got, want, eager):
        same(g, w)
        same(e, w)


def test_binary_auroc_and_ap_traced_over_buffers_match_eager():
    batches = [binary_case("ignore", s) for s in range(3)]
    for name in ("BinaryAUROC", "BinaryAveragePrecision"):
        got, want, eager = buffered(getattr(jc, name)(cat_capacity=256, ignore_index=-1),
                                    getattr(tc, name)(cat_capacity=256, ignore_index=-1, **CPU), batches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=1e-7)


def test_nominal_traced_branches_match_jax():
    rng = np.random.default_rng(6)
    preds = rng.integers(0, 4, 40).astype(np.float32)
    target = rng.integers(0, 4, 40).astype(np.float32)
    preds[3] = np.nan
    jax_drop, port_drop = jn.CramersV(4, nan_strategy="drop"), tn.CramersV(4, nan_strategy="drop", **CPU)
    with pytest.raises(ValueError) as want:
        jax.jit(lambda p, t: jax_drop.local_update(jax_drop.init_state(), p, t))(jnp.asarray(preds), jnp.asarray(target))
    with tracing(), pytest.raises(ValueError) as got:
        port_drop.local_update(port_drop.init_state(), torch.tensor(preds), torch.tensor(target))
    assert str(got.value) == str(want.value)
    jax_rep, port_rep = jn.CramersV(4), tn.CramersV(4, **CPU)
    want = jax.jit(lambda p, t: jax_rep.local_update(jax_rep.init_state(), p, t))(jnp.asarray(preds), jnp.asarray(target))
    with tracing():  # the label check is skipped, the NaN replaced
        got = port_rep.local_update(port_rep.init_state(), torch.tensor(preds), torch.tensor(target))
    assert np.array_equal(got["confmat"].numpy(), np.asarray(want["confmat"]).astype(np.int64))


@pytest.mark.parametrize("capacity", [64, 300])
def test_retrieval_traced_takes_the_dense_buffer(capacity):
    rng = np.random.default_rng(7)
    n = 60
    batch = (rng.random(n).astype(np.float32), rng.integers(0, 2, n), rng.integers(0, 6, n))
    got, want, eager = buffered(jr.RetrievalMAP(cat_capacity=capacity), tr.RetrievalMAP(cat_capacity=capacity, **CPU),
                                [batch])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=1e-6)
