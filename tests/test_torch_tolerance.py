"""The ``tolerance > 0`` tier of metrics_tpu_torch against metrics_tpu, on the CPU.

Mirrors the JAX package's ``tests/unittests/classification/test_tolerance_dispatch.py``
sweep (six classes, N = 2^12, 4 lanes) against the JAX classes:

- ``tolerance=0`` is bit-identical to the exact tier, its cat states untouched;
- a routed class's ``pos_hist``/``neg_hist`` are bit-equal to the JAX class's, its
  value the JAX midpoint within 1e-6 (AUROC) or the float64 midpoint of the port's AP
  bracket from those histograms within 1e-6 (AP), the exact value inside the bracket;
- two faults of the JAX package's AP bracket that the port does not copy: the sign of
  the third term of its ψ expansion, and an upper bound that runs of tied positives
  exceed (its bracket misses the exact AP on both; the port's holds it);
- the functional route and its fallback when the bracket is wider than ``tolerance``,
  ``force_tier("sketch")``, the micro multilabel sum, degenerate lanes (AUROC 0.0, AP
  NaN), the structural errors, ``dispatch_counts()`` and fixed-size state over 20
  updates; ``load_jax_state`` of the histogram states; the route inside a trace.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional as tf
from metrics_tpu.ops import clf_curve as jcc
from metrics_tpu.ops import rank as jrank
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.ops import clf_curve as tcc
from metrics_tpu_torch.ops import rank as trank
from metrics_tpu_torch.utils.checks import tracing
from tests.torch_sketch_helpers import ap_bounds64, ap_midpoint64, reduce64

CPU = "cpu"
ATOL = 1e-6
N = 1 << 12
NC = 4

_rng = np.random.RandomState(99)
PREDS_B = _rng.rand(N).astype(np.float32)
TARGET_B = _rng.randint(0, 2, N).astype(np.int32)
PREDS_MC = np.asarray(jax.nn.softmax(jnp.asarray(_rng.randn(N, NC).astype(np.float32)), axis=-1))
TARGET_MC = _rng.randint(0, NC, N).astype(np.int32)
PREDS_ML = _rng.rand(N, NC).astype(np.float32)
TARGET_ML = _rng.randint(0, 2, (N, NC)).astype(np.int32)

SWEEP = [
    ("binary_auroc", "BinaryAUROC", {}, PREDS_B, TARGET_B),
    ("binary_ap", "BinaryAveragePrecision", {}, PREDS_B, TARGET_B),
    ("multiclass_auroc", "MulticlassAUROC", {"num_classes": NC}, PREDS_MC, TARGET_MC),
    ("multiclass_ap", "MulticlassAveragePrecision", {"num_classes": NC}, PREDS_MC, TARGET_MC),
    ("multilabel_auroc", "MultilabelAUROC", {"num_labels": NC}, PREDS_ML, TARGET_ML),
    ("multilabel_ap", "MultilabelAveragePrecision", {"num_labels": NC}, PREDS_ML, TARGET_ML),
]
IDS = [s[0] for s in SWEEP]


def _bitwise_equal(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.array_equal(a, b, equal_nan=True) and np.array_equal(np.signbit(a), np.signbit(b))


def _port(name, **kw):
    return getattr(tc, name)(device=CPU, **kw)


def _jax(name, **kw):
    return getattr(jc, name)(**kw)


def _update_both(jm, tm, preds, target):
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))


@pytest.mark.parametrize("op,name,kw,preds,target", SWEEP, ids=IDS)
def test_tolerance_zero_is_bit_identical(op, name, kw, preds, target):
    plain, explicit = _port(name, **kw), _port(name, tolerance=0.0, **kw)
    for m in (plain, explicit):
        m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert _bitwise_equal(plain.compute(), explicit.compute())
    assert hasattr(explicit, "preds") and not hasattr(explicit, "pos_hist")


AVERAGED = [(*case, average) for case in SWEEP for average in (("none", "macro", "weighted") if case[2] else (None,))]


@pytest.mark.parametrize("op,name,kw,preds,target,average", AVERAGED, ids=[f"{c[0]}-{c[-1]}" for c in AVERAGED])
def test_routed_value_is_the_jax_midpoint_and_holds_the_exact_value(op, name, kw, preds, target, average):
    kw = {**kw, "average": average} if kw else kw
    jm, tm = _jax(name, tolerance=0.05, **kw), _port(name, tolerance=0.05, **kw)
    _update_both(jm, tm, preds, target)
    assert tm.pos_hist.dtype == torch.int32
    assert np.array_equal(tm.pos_hist.numpy(), np.asarray(jm.pos_hist))
    assert np.array_equal(tm.neg_hist.numpy(), np.asarray(jm.neg_hist))
    got = tm.compute().numpy()
    if "auroc" in op:
        want = np.asarray(jm.compute())
    else:
        want = reduce64(ap_midpoint64(tm.pos_hist.numpy(), tm.neg_hist.numpy()), average, tm.pos_hist.sum(-1).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if average not in ("none", None):
        return
    exact = _port(name, **kw)
    exact.update(torch.from_numpy(preds), torch.from_numpy(target))
    oracle = exact.compute().numpy()
    bounds = trank.hist_auroc_bounds if "auroc" in op else trank.hist_ap_bounds
    lo, hi = (b.numpy() for b in bounds(tm.pos_hist, tm.neg_hist))
    assert np.all(oracle >= lo - ATOL) and np.all(oracle <= hi + ATOL)
    np.testing.assert_allclose(got, 0.5 * (lo + hi), rtol=0, atol=ATOL)
    assert np.all(np.abs(got - oracle) <= 0.5 * (hi - lo) + ATOL)


@pytest.mark.parametrize("fn", ["auroc", "ap"])
def test_functional_route_and_fallback(fn):
    t_fn = tcc.binary_auroc_exact if fn == "auroc" else tcc.binary_average_precision_exact
    j_fn = jcc.binary_auroc_exact if fn == "auroc" else jcc.binary_average_precision_exact
    p, t = torch.from_numpy(PREDS_B), torch.from_numpy(TARGET_B)
    base = t_fn(p, t)
    assert _bitwise_equal(base, t_fn(p, t, tolerance=0.0))
    assert _bitwise_equal(base, t_fn(p, t, tolerance=1e-12))  # the bracket cannot meet it
    trank.reset_dispatch_counts()
    routed = t_fn(p, t, tolerance=0.5, tolerance_bits=10)
    assert trank.dispatch_counts()["rank/dispatch/sketch"] == 1
    if fn == "auroc":
        want = j_fn(jnp.asarray(PREDS_B), jnp.asarray(TARGET_B), tolerance=0.5, tolerance_bits=10)
    else:
        jp, jn = jrank.hist_class_counts(jnp.asarray(PREDS_B), jnp.asarray(TARGET_B) == 1,
                                         jnp.ones(N, bool), bits=10)
        want = ap_midpoint64(np.asarray(jp), np.asarray(jn))
    np.testing.assert_allclose(routed.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not _bitwise_equal(base, routed)
    public = tf.binary_auroc if fn == "auroc" else tf.binary_average_precision
    got = public(PREDS_B, TARGET_B, tolerance=0.5, tolerance_bits=10, device=CPU)
    assert _bitwise_equal(got, routed)
    # inside a trace the width cannot be read: the exact tier serves
    with tracing():
        assert _bitwise_equal(t_fn(p, t, tolerance=0.5, tolerance_bits=10), base)


def test_partial_auc_always_takes_the_exact_tier():
    p, t = torch.from_numpy(PREDS_B), torch.from_numpy(TARGET_B)
    assert _bitwise_equal(tcc.binary_auroc_exact(p, t, max_fpr=0.3, tolerance=0.9),
                          tcc.binary_auroc_exact(p, t, max_fpr=0.3))


def test_force_tier_sketch():
    p, t = torch.from_numpy(PREDS_B), torch.from_numpy(TARGET_B)
    with trank.force_tier("sketch"):
        assert trank.select_tier(p) == "sort"
        got_auroc = tcc.binary_auroc_exact(p, t, tolerance_bits=8)
        got_ap = tcc.binary_average_precision_exact(p, t, tolerance_bits=8)
    with jrank.force_tier("sketch"):
        want_auroc = jcc.binary_auroc_exact(jnp.asarray(PREDS_B), jnp.asarray(TARGET_B), tolerance_bits=8)
    np.testing.assert_allclose(got_auroc.numpy(), np.asarray(want_auroc), rtol=0, atol=ATOL)
    pos, neg = trank.hist_class_counts(p, t == 1, t >= 0, 8)
    np.testing.assert_allclose(got_ap.numpy(), ap_midpoint64(pos.numpy(), neg.numpy()), rtol=0, atol=ATOL)
    lo, hi = trank.sketch_auroc_bracket(p, t, t >= 0, bits=8)
    assert float(got_auroc) == pytest.approx(0.5 * float(lo + hi), abs=ATOL)
    with pytest.raises(ValueError):
        with trank.force_tier("bogus"):
            pass


def test_multilabel_micro_uses_the_summed_lanes():
    for name in ("MultilabelAUROC", "MultilabelAveragePrecision"):
        jm = _jax(name, num_labels=NC, average="micro", tolerance=0.05)
        tm = _port(name, num_labels=NC, average="micro", tolerance=0.05)
        _update_both(jm, tm, PREDS_ML, TARGET_ML)
        got = float(tm.compute())
        if "AUROC" in name:
            assert got == pytest.approx(float(jm.compute()), abs=ATOL)
        else:
            summed = (tm.pos_hist.sum(0).numpy(), tm.neg_hist.sum(0).numpy())
            assert got == pytest.approx(float(ap_midpoint64(*summed)), abs=ATOL)
        bounds = trank.hist_auroc_bounds if "AUROC" in name else trank.hist_ap_bounds
        lo, hi = (float(b) for b in bounds(tm.pos_hist.sum(0), tm.neg_hist.sum(0)))
        exact = _port(name, num_labels=NC, average="micro")
        exact.update(torch.from_numpy(PREDS_ML), torch.from_numpy(TARGET_ML))
        assert lo - ATOL <= float(exact.compute()) <= hi + ATOL
        assert got == pytest.approx(0.5 * (lo + hi), abs=ATOL)


def test_degenerate_lanes_match_the_exact_conventions():
    target = np.random.RandomState(5).randint(0, NC - 1, N).astype(np.int32)  # class 3 never appears
    jm = _jax("MulticlassAUROC", num_classes=NC, average="none", tolerance=0.1)
    tm = _port("MulticlassAUROC", num_classes=NC, average="none", tolerance=0.1)
    _update_both(jm, tm, PREDS_MC, target)
    assert float(tm.compute()[NC - 1]) == 0.0
    tml = TARGET_ML.copy()
    tml[:, 0] = 0  # a label without positives
    jm = _jax("MultilabelAveragePrecision", num_labels=NC, average="none", tolerance=0.1)
    tm = _port("MultilabelAveragePrecision", num_labels=NC, average="none", tolerance=0.1)
    _update_both(jm, tm, PREDS_ML, tml)
    res = tm.compute().numpy()
    assert np.isnan(res[0]) and not np.any(np.isnan(res[1:]))
    assert np.array_equal(tm.pos_hist.numpy(), np.asarray(jm.pos_hist))
    np.testing.assert_allclose(res, ap_midpoint64(tm.pos_hist.numpy(), tm.neg_hist.numpy()), rtol=0, atol=ATOL,
                               equal_nan=True)
    with pytest.warns(UserWarning, match="nan"):  # the NaN lane leaves the macro average
        macro = _port("MultilabelAveragePrecision", num_labels=NC, tolerance=0.1)
        macro.update(torch.from_numpy(PREDS_ML), torch.from_numpy(tml))
        assert float(macro.compute()) == pytest.approx(float(np.nanmean(res)), abs=ATOL)


def test_ignore_index_rows_drop_out_of_the_histograms():
    target = TARGET_MC.copy()
    target[::7] = -1
    jm = _jax("MulticlassAveragePrecision", num_classes=NC, average="none", tolerance=0.1, ignore_index=-1)
    tm = _port("MulticlassAveragePrecision", num_classes=NC, average="none", tolerance=0.1, ignore_index=-1)
    _update_both(jm, tm, PREDS_MC, target)
    assert np.array_equal(tm.pos_hist.numpy(), np.asarray(jm.pos_hist))
    assert int((tm.pos_hist + tm.neg_hist).sum()) == NC * int((target >= 0).sum())
    np.testing.assert_allclose(tm.compute().numpy(), ap_midpoint64(tm.pos_hist.numpy(), tm.neg_hist.numpy()),
                               rtol=0, atol=ATOL)


def test_structural_errors():
    for build in (_port, _jax):
        with pytest.raises(ValueError, match="scalar sketch-computable"):
            build("BinaryPrecisionRecallCurve", tolerance=0.1)
        with pytest.raises(ValueError, match="scalar sketch-computable"):
            build("MulticlassROC", num_classes=3, tolerance=0.1)
        with pytest.raises(ValueError, match="exact mode only"):
            build("BinaryAUROC", tolerance=0.1, thresholds=5)
        with pytest.raises(ValueError, match="exact mode only"):
            build("BinaryAUROC", tolerance=0.1, thresholds=5, validate_args=False)
        with pytest.raises(ValueError, match="non-negative"):
            build("BinaryAUROC", tolerance=-0.5)
        with pytest.raises(ValueError, match=r"\[4, 14\]"):
            build("BinaryAUROC", tolerance=0.1, tolerance_bits=3)
        with pytest.raises(ValueError, match=r"\[4, 14\]"):
            build("MulticlassAveragePrecision", num_classes=3, tolerance=0.1, tolerance_bits=15)
        with pytest.raises(ValueError, match="full-range AUROC only"):
            build("BinaryAUROC", tolerance=0.1, max_fpr=0.5)
    assert "tolerance" in tc.BinaryAUROC._update_signature_attrs
    assert "tolerance_bits" in tc.BinaryAUROC._update_signature_attrs


def test_fixed_size_state_and_dispatch_counts_over_20_updates():
    metric = _port("MultilabelAUROC", num_labels=NC, tolerance=0.02, tolerance_bits=10)
    assert set(metric._defaults) == {"pos_hist", "neg_hist"}
    assert not hasattr(metric, "preds") and not metric._cat_meta
    rng = np.random.default_rng(20)
    chunks = []
    for _ in range(20):
        p = rng.random((512, NC)).astype(np.float32)
        t = rng.integers(0, 2, (512, NC)).astype(np.int32)
        chunks.append((p, t))
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
        assert metric.pos_hist.shape == metric.neg_hist.shape == (NC, 1 << 10)
    assert int((metric.pos_hist + metric.neg_hist).sum()) == 20 * 512 * NC
    trank.reset_dispatch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the realized width may exceed 0.02 at 10 bits
        got = float(metric.compute())
    counts = trank.dispatch_counts()
    assert counts["rank/dispatch/sketch"] == 1 and counts["rank/op/multilabel_auroc"] == 1
    jm = _jax("MultilabelAUROC", num_labels=NC, tolerance=0.02, tolerance_bits=10)
    for p, t in chunks:
        jm.update(jnp.asarray(p), jnp.asarray(t))
    assert got == pytest.approx(float(jm.compute()), abs=ATOL)


def test_exact_tiers_record_their_dispatch():
    trank.reset_dispatch_counts()
    tcc.binary_auroc_exact(torch.from_numpy(PREDS_B), torch.from_numpy(TARGET_B))
    tcc.multiclass_average_precision_exact(torch.from_numpy(PREDS_MC), torch.from_numpy(TARGET_MC))
    assert trank.dispatch_counts() == {
        "rank/dispatch/sort": 2, "rank/op/binary_auroc": 1, "rank/op/multiclass_ap": 1}


def test_width_warning_and_load_jax_state():
    jm = _jax("BinaryAveragePrecision", tolerance=1e-6, tolerance_bits=6)
    jm.update(jnp.asarray(PREDS_B), jnp.asarray(TARGET_B))
    jm.persistent(True)
    tm = load_jax_state(_port("BinaryAveragePrecision", tolerance=1e-6, tolerance_bits=6), jm.state_dict())
    assert np.array_equal(tm.pos_hist.numpy(), np.asarray(jm.pos_hist))
    with pytest.warns(UserWarning, match="exceeds tolerance"):
        got = float(tm.compute())
    assert got == pytest.approx(float(ap_midpoint64(tm.pos_hist.numpy(), tm.neg_hist.numpy())), abs=ATOL)
    more = _rng.rand(300).astype(np.float32), _rng.randint(0, 2, 300).astype(np.int32)
    _update_both(jm, tm, *more)
    assert np.array_equal(tm.neg_hist.numpy(), np.asarray(jm.neg_hist))


def test_routed_classes_fuse_and_take_a_fleet_axis():
    coll = MetricCollection({"auroc": _port("BinaryAUROC", tolerance=0.05),
                             "ap": _port("BinaryAveragePrecision", tolerance=0.05)}, fused=True)
    eager = _port("BinaryAUROC", tolerance=0.05)
    fleet = _port("MulticlassAUROC", num_classes=NC, tolerance=0.05, fleet_size=3)
    apart = [_port("MulticlassAUROC", num_classes=NC, tolerance=0.05) for _ in range(3)]
    rng = np.random.default_rng(21)
    for i in range(3):
        lo, hi = i * 1000, (i + 1) * 1000
        p, t = torch.from_numpy(PREDS_B[lo:hi]), torch.from_numpy(TARGET_B[lo:hi])
        coll.update(p, t)
        eager.update(p, t)
        sid = torch.from_numpy(rng.integers(0, 3, 1000))
        pm, tmc = torch.from_numpy(PREDS_MC[lo:hi]), torch.from_numpy(TARGET_MC[lo:hi])
        fleet.update(pm, tmc, stream_ids=sid)
        for s in range(3):
            apart[s].update(pm[sid == s], tmc[sid == s])
    assert torch.equal(coll["auroc"].pos_hist, eager.pos_hist) and torch.equal(coll["auroc"].neg_hist, eager.neg_hist)
    assert _bitwise_equal(coll.compute()["auroc"], eager.compute())
    for s in range(3):
        assert torch.equal(fleet.pos_hist[s], apart[s].pos_hist) and torch.equal(fleet.neg_hist[s], apart[s].neg_hist)


def test_ap_bounds_are_the_float64_closed_forms():
    rng = np.random.default_rng(22)
    pos = rng.integers(0, 50, (3, 256)).astype(np.int32)
    neg = rng.integers(0, 500, (3, 256)).astype(np.int32)
    pos[1] = 0  # no positives: [0, 0]
    lo, hi = trank.hist_ap_bounds(torch.from_numpy(pos), torch.from_numpy(neg))
    want_lo, want_hi = ap_bounds64(pos, neg)
    np.testing.assert_allclose(lo.numpy(), want_lo, rtol=0, atol=ATOL)
    np.testing.assert_allclose(hi.numpy(), want_hi, rtol=0, atol=ATOL)
    # the JAX package's AUROC bounds are the port's
    jlo, jhi = jrank.hist_auroc_bounds(jnp.asarray(pos), jnp.asarray(neg))
    tlo, thi = trank.hist_auroc_bounds(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=0, atol=ATOL)
    np.testing.assert_allclose(thi.numpy(), np.asarray(jhi), rtol=0, atol=ATOL)


def test_psi_expansion_sign_of_the_reference_is_not_copied():
    from scipy.special import digamma

    a = np.array([8.0, 9.0, 16.0, 50.0, 1e6], np.float32)
    p = np.array([10.0, 3.0, 1.0, 10.0, 7.0], np.float32)
    want = digamma(a.astype(np.float64) + p) - digamma(a.astype(np.float64))
    got = trank._psi_diff(torch.from_numpy(a), torch.from_numpy(p)).numpy()
    assert np.all(np.abs(got - want) <= 2e-6 * np.maximum(want, 1.0))
    reference = np.asarray(jrank._psi_diff(jnp.asarray(a), jnp.asarray(p)))
    assert abs(reference[0] - want[0]) > 1e-3  # the JAX package's minus sign: p/(3a^3) off


@pytest.mark.parametrize("tied", [True, False])
def test_ap_bracket_holds_the_exact_value_where_the_reference_misses_it(tied):
    # eight negatives, then three positives in one bucket: tied, or three distinct scores
    scores = [0.9] * 8 + ([0.5] * 3 if tied else [0.5, 0.50001, 0.50002])
    p = np.asarray(scores, np.float32)
    t = np.asarray([0] * 8 + [1] * 3, np.int32)
    valid = np.ones(11, bool)
    exact = float(tcc.binary_average_precision_exact(torch.from_numpy(p), torch.from_numpy(t)))
    assert exact == pytest.approx(3 / 11 if tied else (1 / 9 + 2 / 10 + 3 / 11) / 3, abs=ATOL)
    lo, hi, _ = trank.sketch_ap_bracket(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(valid), 12)
    assert float(lo) - ATOL <= exact <= float(hi) + ATOL
    jlo, jhi, _ = jrank.sketch_ap_bracket(jnp.asarray(p), jnp.asarray(t), jnp.asarray(valid), bits=12)
    assert not float(jlo) - ATOL <= exact <= float(jhi) + ATOL
