"""The exact and binned curve family of metrics_tpu_torch against metrics_tpu, on the CPU.

Seeded numpy inputs go through the JAX package and the port (``device="cpu"``):
precision-recall curve, ROC, AUROC and average precision, as functionals and as
classes, binary / multiclass / multilabel, exact (``thresholds=None``) and binned,
with ``ignore_index``, ``max_fpr`` and every average. Integer run-end counts
(``fps``, ``tps``) must be bit-equal to the JAX package's; float results agree
within rtol 1e-6, atol 1e-6 (sums are taken in another order). The port's rank tier
must be bit-identical to its sort tier, and both to the JAX package on the
``ops/rank.py`` adversarial inputs (ties, ±inf, denormals, -0.0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.ops import clf_curve as jcc
from metrics_tpu.ops import rank as jrank
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.ops import clf_curve as tcc
from metrics_tpu_torch.ops import rank as trank
from metrics_tpu_torch.ops import segment

C, L = 4, 3
_TINY = np.finfo(np.float32).tiny


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for item in x:
            yield from _leaves(item)
    else:
        yield x


def assert_close(got, want):
    got_leaves, want_leaves = list(_leaves(got)), list(_leaves(want))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-6, atol=1e-6)


def batches(task, seed=0, n=3, ignore_index=None, logits=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if task == "binary":
            preds, target = rng.rand(16, 5).astype(np.float32), rng.randint(0, 2, (16, 5))
        elif task == "multiclass":
            preds, target = rng.rand(16, C, 5).astype(np.float32), rng.randint(0, C, (16, 5))
        else:
            preds, target = rng.rand(16, L, 5).astype(np.float32), rng.randint(0, 2, (16, L, 5))
        if logits:
            preds = (preds - 0.5) * 8
        # coarse scores make long tie runs
        preds = np.round(preds * 16) / 16
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.15] = ignore_index
        out.append((preds.astype(np.float32), target))
    return out


def _ctor_args(task):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(task, {})


def make(name, task, kwargs, device=None):
    prefix = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task]
    kw = dict(_ctor_args(task), **kwargs)
    if device is None:
        return getattr(jc, prefix + name)(**kw)
    return getattr(tc, prefix + name)(**kw, device=device)


CASES = [
    ("PrecisionRecallCurve", "binary", {}),
    ("PrecisionRecallCurve", "binary", {"thresholds": 5}),
    ("PrecisionRecallCurve", "multiclass", {"ignore_index": -1}),
    ("PrecisionRecallCurve", "multiclass", {"thresholds": [0.1, 0.5, 0.9]}),
    ("PrecisionRecallCurve", "multilabel", {"thresholds": 7, "ignore_index": 255}),
    ("PrecisionRecallCurve", "multilabel", {}),
    ("ROC", "binary", {"ignore_index": 255}),
    ("ROC", "binary", {"thresholds": 11}),
    ("ROC", "multiclass", {}),
    ("ROC", "multiclass", {"thresholds": 6, "ignore_index": -1}),
    ("ROC", "multilabel", {"ignore_index": 255}),
    ("AUROC", "binary", {}),
    ("AUROC", "binary", {"max_fpr": 0.3, "ignore_index": 255}),
    ("AUROC", "binary", {"thresholds": 9}),
    ("AUROC", "binary", {"thresholds": 9, "max_fpr": 0.5}),
    ("AUROC", "multiclass", {"average": "macro"}),
    ("AUROC", "multiclass", {"average": "weighted", "ignore_index": -1}),
    ("AUROC", "multiclass", {"average": "none", "thresholds": 8}),
    ("AUROC", "multiclass", {"average": "weighted", "thresholds": 8}),
    ("AUROC", "multilabel", {"average": "micro"}),
    ("AUROC", "multilabel", {"average": "macro", "ignore_index": 255}),
    ("AUROC", "multilabel", {"average": "none", "thresholds": 5}),
    ("AveragePrecision", "binary", {}),
    ("AveragePrecision", "binary", {"ignore_index": 255, "thresholds": 10}),
    ("AveragePrecision", "multiclass", {"average": "macro", "ignore_index": -1}),
    ("AveragePrecision", "multiclass", {"average": "none"}),
    ("AveragePrecision", "multiclass", {"average": "weighted", "thresholds": [0.0, 0.25, 0.5, 0.75, 1.0]}),
    ("AveragePrecision", "multilabel", {"average": "micro", "thresholds": 6}),
    ("AveragePrecision", "multilabel", {"average": "weighted"}),
]


def _case_id(case):
    name, task, kwargs = case
    return f"{name}-{task}-" + "-".join(f"{k}={v}" for k, v in kwargs.items())


@pytest.mark.parametrize("name, task, kwargs", CASES, ids=[_case_id(c) for c in CASES])
def test_class_matches_jax(name, task, kwargs):
    jm, tm = make(name, task, kwargs), make(name, task, kwargs, "cpu")
    for preds, target in batches(task, seed=1, ignore_index=kwargs.get("ignore_index")):
        assert_close(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)))
    assert_close(tm.compute(), jm.compute())


FUNCTIONAL = [
    ("precision_recall_curve", "binary", {}),
    ("precision_recall_curve", "multiclass", {"thresholds": 5}),
    ("roc", "multilabel", {}),
    ("roc", "binary", {"thresholds": [0.2, 0.4, 0.6]}),
    ("auroc", "binary", {"max_fpr": 0.2}),
    ("auroc", "multiclass", {"average": "weighted"}),
    ("auroc", "multilabel", {"average": "micro", "ignore_index": 255}),
    ("average_precision", "binary", {"ignore_index": 255}),
    ("average_precision", "multiclass", {"average": "none", "thresholds": 7}),
    ("average_precision", "multilabel", {"average": "macro"}),
]


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("name, task, kwargs", FUNCTIONAL, ids=[_case_id(c) for c in FUNCTIONAL])
def test_functional_matches_jax(name, task, kwargs, logits):
    preds, target = batches(task, seed=2, n=1, ignore_index=kwargs.get("ignore_index"), logits=logits)[0]
    fn_name = f"{task}_{name}"
    kw = dict(_ctor_args(task), **kwargs)
    want = getattr(jf, fn_name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = getattr(tf, fn_name)(preds, target, **kw, device="cpu")
    assert_close(got, want)
    dispatched = getattr(tf, name)(preds, target, task=task, **kw, device="cpu")
    assert_close(dispatched, want)


# ------------------------------------------------------------- adversarial inputs

_rng = np.random.RandomState(1234)


def _labels(n, p=0.4):
    return (_rng.rand(n) < p).astype(np.int32)


# the adversarial suite of tests/unittests/classification/test_rank_engine.py
ADVERSARIAL = {
    "random": (_rng.rand(777).astype(np.float32), _labels(777)),
    "tie_heavy": ((_rng.randint(0, 5, 1500) / 4.0).astype(np.float32), _labels(1500)),
    "all_equal": (np.full(300, 0.25, np.float32), _labels(300)),
    "two_values": (np.where(_rng.rand(512) < 0.5, 0.1, 0.9).astype(np.float32), _labels(512)),
    "pm_inf": (
        np.where(_rng.rand(600) < 0.2, np.inf, np.where(_rng.rand(600) < 0.2, -np.inf, _rng.randn(600))).astype(
            np.float32
        ),
        _labels(600),
    ),
    "denormal": ((_rng.randn(500) * 1e-38).astype(np.float32), _labels(500)),
    "negative_zero": (
        np.where(_rng.rand(400) < 0.3, -0.0, np.where(_rng.rand(400) < 0.3, 0.0, _rng.randn(400))).astype(np.float32),
        _labels(400),
    ),
    "all_positive_labels": (_rng.rand(200).astype(np.float32), np.ones(200, np.int32)),
    "all_negative_labels": (_rng.rand(200).astype(np.float32), np.zeros(200, np.int32)),
    "extreme_magnitudes": (
        np.concatenate(
            [
                [np.finfo(np.float32).max, -np.finfo(np.float32).max, _TINY, -_TINY, 0.0, -0.0],
                _rng.randn(250).astype(np.float32) * 1e30,
            ]
        ).astype(np.float32),
        _labels(256),
    ),
}
_pads = _labels(800)
_pads[_rng.rand(800) < 0.25] = -1
ADVERSARIAL["ignore_index"] = (_rng.randn(800).astype(np.float32), _pads)


def _bitwise_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True) and np.array_equal(np.signbit(a), np.signbit(b))


@pytest.mark.parametrize("tier", ["sort", "rank"])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_run_end_counts_bit_equal_to_jax(case, tier):
    preds, target = ADVERSARIAL[case]
    want = jcc._run_end_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(target) >= 0)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    got = tcc._run_end_counts(p, t, t >= 0, tier=tier)
    for name, g, w in zip(("fps", "tps", "boundary"), got[:2] + got[3:], want[:2] + want[3:]):
        assert _bitwise_equal(g, w), f"{case}/{tier}: {name}"
    # sk: equal outside the zero-exponent class, which the port keys as +0.0 on both tiers
    sk_w, sk_g = np.asarray(want[2]), got[2].numpy()
    flushed = np.abs(sk_w) < _TINY
    assert _bitwise_equal(sk_g[~flushed], sk_w[~flushed])
    assert (sk_g[flushed] == 0.0).all() and not np.signbit(sk_g[flushed]).any()


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_rank_tier_is_bit_identical_to_sort_tier(case):
    preds, target = ADVERSARIAL[case]
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    sort = tcc._run_end_counts(p, t, t >= 0, tier="sort")
    rank = tcc._run_end_counts(p, t, t >= 0, tier="rank")
    for a, b in zip(sort, rank):
        assert _bitwise_equal(a, b)
    for max_fpr in (None, 0.25):
        results = []
        for tier in ("sort", "rank"):
            with trank.force_tier(tier):
                results.append(tcc.binary_auroc_exact(p, t, max_fpr=max_fpr))
        assert _bitwise_equal(*results)
    with trank.force_tier("sort"):
        ap_sort = tcc.binary_average_precision_exact(p, t)
    with trank.force_tier("rank"):
        ap_rank = tcc.binary_average_precision_exact(p, t)
    assert _bitwise_equal(ap_sort, ap_rank)


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_exact_scalars_match_jax_on_both_tiers(case):
    preds, target = ADVERSARIAL[case]
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    for tier in ("sort", "rank"):
        with jrank.force_tier(tier), trank.force_tier(tier):
            for max_fpr in (None, 0.25):
                want = jcc.binary_auroc_exact(jnp.asarray(preds), jnp.asarray(target), max_fpr=max_fpr)
                assert_close(tcc.binary_auroc_exact(p, t, max_fpr=max_fpr), want)
            want = jcc.binary_average_precision_exact(jnp.asarray(preds), jnp.asarray(target))
            assert_close(tcc.binary_average_precision_exact(p, t), want)


_PROBABILITIES = {
    "tie_heavy": ADVERSARIAL["tie_heavy"],
    "denormal_and_signed_zero": (
        np.where(
            _rng.rand(600) < 0.3,
            np.where(_rng.rand(600) < 0.5, -0.0, 0.0),
            np.abs(_rng.randn(600) * 1e-38) * (_rng.rand(600) < 0.5) + (_rng.rand(600) < 0.2) * _rng.rand(600),
        ).astype(np.float32),
        _labels(600),
    ),
}


@pytest.mark.parametrize("case", ["tie_heavy", "pm_inf", "denormal", "negative_zero", "extreme_magnitudes"])
def test_eager_curve_matches_jax(case):
    preds, target = ADVERSARIAL[case]
    want = jf.binary_roc(jnp.asarray(preds), jnp.asarray(target), validate_args=False)
    assert_close(tf.binary_roc(preds, target, validate_args=False, device="cpu"), want)
    want = jf.binary_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), validate_args=False)
    assert_close(tf.binary_precision_recall_curve(preds, target, validate_args=False, device="cpu"), want)


@pytest.mark.parametrize("case", sorted(_PROBABILITIES))
def test_eager_curve_keeps_denormals_and_signed_zeros(case):
    """Probabilities skip the sigmoid, so the thresholds are the scores themselves: bit
    for bit, denormals distinct from zero and the sign of zero kept, as numpy keeps them."""
    preds, target = _PROBABILITIES[case]
    for j_fn, t_fn in ((jf.binary_roc, tf.binary_roc), (jf.binary_precision_recall_curve, tf.binary_precision_recall_curve)):
        want = j_fn(jnp.asarray(preds), jnp.asarray(target), validate_args=False)
        got = t_fn(preds, target, validate_args=False, device="cpu")
        assert_close(got, want)
        assert _bitwise_equal(got[2], want[2])


def test_key_bijection_matches_jax():
    vals = np.concatenate(
        [
            _rng.randn(2000).astype(np.float32) * np.exp(_rng.randn(2000) * 20).astype(np.float32),
            np.array([0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0, np.inf, -np.inf, _TINY, -_TINY], np.float32),
            np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32),
        ]
    ).astype(np.float32)
    valid = _rng.rand(len(vals)) < 0.9
    want = np.asarray(jrank.monotone_key_descending(jnp.asarray(vals), jnp.asarray(valid))).astype(np.int64)
    got = trank.monotone_key_descending(torch.from_numpy(vals), torch.from_numpy(valid))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    inv_w = np.asarray(jrank.key_to_f32_descending(jnp.asarray(want.astype(np.uint32))))
    assert _bitwise_equal(trank.key_to_f32_descending(got), inv_w)
    assert int(trank.monotone_key_descending(torch.tensor([-np.inf]))[0]) == trank.NEG_INF_KEY


# ------------------------------------------------------------------------ utils


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("shape", ["ascending", "descending", "ties", "rows"])
def test_auc_compute_matches_jax(shape, reorder):
    from metrics_tpu.utils.compute import _auc_compute as j_auc
    from metrics_tpu_torch.utils.compute import _auc_compute

    rng = np.random.RandomState(7)
    x = np.sort(rng.rand(33)).astype(np.float32)
    y = rng.rand(33).astype(np.float32)
    if shape == "descending":
        x = x[::-1].copy()
    elif shape == "ties":
        x = np.round(x * 4) / 4
        if reorder:
            rng.shuffle(x)
    elif shape == "rows":
        x, y = np.stack([x, x[::-1]]), np.stack([y, y])
    assert_close(_auc_compute(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder), j_auc(x, y, reorder=reorder))


def test_next_pow2_matches_jax():
    from metrics_tpu.utils.data import _next_pow2 as j_next_pow2
    from metrics_tpu_torch.utils.data import _next_pow2

    for n in (0, 1, 2, 3, 1000, 1024, 1025, 89_137_319):
        for floor in (1, 8, 1024):
            assert _next_pow2(n, floor) == j_next_pow2(n, floor)


# ------------------------------------------------------------------ degenerate data


def test_degenerate_data():
    p = np.linspace(0.1, 0.9, 40).astype(np.float32)
    ones, zeros = np.ones(40, np.int64), np.zeros(40, np.int64)
    for target in (ones, zeros):
        got = tf.binary_auroc(p, target, device="cpu")
        assert float(got) == 0.0 == float(jf.binary_auroc(jnp.asarray(p), jnp.asarray(target)))
        assert np.isnan(float(tf.binary_auroc(p, target, max_fpr=0.5, device="cpu")))
        assert np.isnan(float(jf.binary_auroc(jnp.asarray(p), jnp.asarray(target), max_fpr=0.5)))
    assert np.isnan(float(tf.binary_average_precision(p, zeros, device="cpu")))
    assert float(tf.binary_average_precision(p, ones, device="cpu")) == 1.0
    # a class that never occurs: AUROC 0.0 in the macro average, AP NaN and dropped
    rng = np.random.RandomState(3)
    preds = rng.rand(50, C).astype(np.float32)
    target = rng.randint(0, C - 1, 50)
    for name in ("multiclass_auroc", "multiclass_average_precision"):
        for average in ("macro", "weighted", "none"):
            want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), num_classes=C, average=average)
            assert_close(getattr(tf, name)(preds, target, num_classes=C, average=average, device="cpu"), want)


def test_thresholds_as_jax_linspace():
    from metrics_tpu.functional.classification.precision_recall_curve import _adjust_threshold_arg as j_adjust
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    for n in (2, 3, 5, 7, 11, 100, 1000):
        assert _bitwise_equal(_adjust_threshold_arg(n, "cpu"), j_adjust(n))


def test_validation_errors():
    p, t = np.random.rand(10).astype(np.float32), np.random.randint(0, 2, 10)
    with pytest.raises(ValueError):
        tc.BinaryAUROC(max_fpr=1.5, device="cpu")
    with pytest.raises(ValueError):
        tc.BinaryROC(thresholds=1, device="cpu")
    with pytest.raises(ValueError):
        tc.MulticlassAUROC(num_classes=3, average="micro", device="cpu")
    with pytest.raises(ValueError):
        tf.binary_auroc(p.astype(np.int64), t, device="cpu")
    with pytest.raises(RuntimeError):
        tf.binary_auroc(p, t + 3, device="cpu")
    with pytest.raises(ValueError):
        tc.BinaryROC(tolerance=0.01, device="cpu")  # curve-shaped: never sketch-computable
    with pytest.raises(ValueError):
        tc.BinaryPrecisionRecallCurve(tolerance=-1.0, device="cpu")


@pytest.mark.parametrize(
    "name, fn_name",
    [("PrecisionRecallCurve", "precision_recall_curve"), ("ROC", "roc"), ("AUROC", "auroc"),
     ("AveragePrecision", "average_precision")],
)
def test_task_dispatchers(name, fn_name):
    prefix = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}
    for task, kw in (("binary", {}), ("multiclass", {"num_classes": C}), ("multilabel", {"num_labels": L})):
        assert type(getattr(tc, name)(task=task, **kw, device="cpu")).__name__ == prefix[task] + name
    fn = getattr(tf, fn_name)
    p, t = np.random.rand(8, C).astype(np.float32), np.random.randint(0, C, 8)
    for task in ("multiclass", "multilabel"):
        with pytest.raises(ValueError, match="is expected to be `int`"):
            getattr(tc, name)(task=task, device="cpu")
        with pytest.raises(ValueError, match="is expected to be `int`"):
            fn(p, t, task=task, device="cpu")


def test_sketch_tier_is_not_ported():
    # the sketch tier is ported since the sketch slice: each of these serves a value
    # (its parity with the JAX package is in tests/test_torch_tolerance.py)
    p, t = torch.rand(10), torch.randint(0, 2, (10,))
    assert tc.BinaryAUROC(tolerance=0.01, device="cpu").pos_hist.shape == (1 << 12,)
    assert tc.MulticlassAveragePrecision(num_classes=3, tolerance=0.01, device="cpu").neg_hist.shape == (3, 1 << 12)
    assert 0.0 <= float(tf.binary_auroc(p, t, tolerance=0.5, device="cpu")) <= 1.0
    assert 0.0 <= float(tcc.binary_average_precision_exact(p, t, tolerance=0.5)) <= 1.0
    with trank.force_tier("sketch"):
        assert trank.select_tier(p) == "sort"


def test_dispatch_cpu_is_sort_tier_and_plain_scan():
    p = torch.rand(trank.RANK_MIN_SIZE)
    assert trank.select_tier(p) == "sort"
    with trank.force_tier("rank"):
        assert trank.select_tier(p) == "rank"
    assert trank.select_tier(p) == "sort"
    before = segment.segment_scan_cuda.launches
    tcc.binary_auroc_exact(p[:1000], (p[:1000] > 0.5).long())
    assert segment.segment_scan_cuda.launches == before


# ----------------------------------------------------------------- the whole slice


@pytest.mark.parametrize("name, kwargs", [("AUROC", {}), ("AUROC", {"max_fpr": 0.1}), ("AveragePrecision", {})])
def test_binary_slice_with_state_carried_from_jax(name, kwargs):
    """A few updates in JAX, the state carried into the port, more updates on both,
    then the port's state carried back into a fresh JAX metric."""
    rng = np.random.RandomState(11)
    data = []
    for _ in range(4):
        target = (rng.rand(512) < 0.03).astype(np.int64)
        scores = 1 / (1 + np.exp(-(rng.randn(512) + 1.5 * target)))
        scores = torch.from_numpy(scores.astype(np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
        data.append((scores, target))
    jm = make(name, "binary", kwargs)
    for preds, target in data[:2]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    jm.persistent(True)
    tm = load_jax_state(make(name, "binary", kwargs, "cpu"), jm.state_dict())
    assert_close(tm.compute(), jm.compute())
    for preds, target in data[2:]:
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(preds, target)
    assert_close(tm.compute(), jm.compute())
    assert [t.dtype for t in tm.preds] == [torch.float32] * 4
    tm.persistent(True)
    back = make(name, "binary", kwargs)
    back.load_state_dict({k: [t.numpy() for t in v] for k, v in tm.state_dict().items()})
    assert_close(tm.compute(), back.compute())


def test_binned_state_carried_from_jax():
    data = batches("multiclass", seed=4, n=2)
    jm = jc.MulticlassAUROC(num_classes=C, thresholds=5)
    jm.update(jnp.asarray(data[0][0]), jnp.asarray(data[0][1]))
    jm.persistent(True)
    tm = load_jax_state(tc.MulticlassAUROC(num_classes=C, thresholds=5, device="cpu"), jm.state_dict())
    assert tm.confmat.dtype == torch.int64
    jm.update(jnp.asarray(data[1][0]), jnp.asarray(data[1][1]))
    tm.update(*data[1])
    assert_close(tm.compute(), jm.compute())


def test_reset_and_merge_state():
    data = batches("binary", seed=5, n=2)
    a, b = tc.BinaryAUROC(device="cpu"), tc.BinaryAUROC(device="cpu")
    a.update(*data[0])
    b.update(*data[1])
    a.merge_state(b)
    both = tc.BinaryAUROC(device="cpu")
    for preds, target in data:
        both.update(preds, target)
    assert_close(a.compute(), both.compute())
    a.reset()
    assert a.preds == [] and a.target == []
