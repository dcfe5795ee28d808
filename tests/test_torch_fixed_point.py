"""The fixed-point curve metrics and ``auc`` of metrics_tpu_torch against metrics_tpu, on the CPU.

Recall at fixed precision, precision at fixed recall and specificity at sensitivity
(binary, multiclass, multilabel; exact and binned thresholds; ``ignore_index``),
functionals and classes, on seeded numpy inputs whose scores are rounded to two
decimals so that the curves have tie runs. The port selects the fixed point with a
masked reduction on the device; the JAX package, run eagerly, on the host. Both
pick an element of the same float32 curve, so the results are compared bit for
bit. ``_lexicographic_best`` is held bit-equal to the JAX package's eager branch on
curves with ties, with no qualifying point, and with a NaN primary.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.functional.classification.recall_fixed_precision import _lexicographic_best as jax_best
from metrics_tpu.functional.classification.specificity_sensitivity import _specificity_at_sensitivity as jax_spec
from metrics_tpu.utils.compute import auc as jax_auc
from metrics_tpu_torch.functional.classification.recall_fixed_precision import _lexicographic_best
from metrics_tpu_torch.functional.classification.specificity_sensitivity import _specificity_at_sensitivity
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.utils.compute import _smallest_f32_at_least, auc

C, L = 4, 3
# (functional stem, class stem, keyword of the fixed value)
FAMILIES = [
    ("recall_at_fixed_precision", "RecallAtFixedPrecision", "min_precision"),
    ("precision_at_fixed_recall", "PrecisionAtFixedRecall", "min_recall"),
    ("specificity_at_sensitivity", "SpecificityAtSensitivity", "min_sensitivity"),
]


def assert_bit_equal(got, want):
    """Float32 results equal bit for bit (NaN to NaN)."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_bit_equal(g, w)
        return
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype == np.float32, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def inputs(task, rng, n=60, ignore_index=None):
    """Scores in [0, 1] with two decimals (tie runs), so that neither side applies a sigmoid or softmax."""
    if task == "binary":
        preds, target = rng.rand(n), rng.randint(0, 2, n)
    elif task == "multiclass":
        preds, target = rng.rand(n, C), rng.randint(0, C, n)
    else:
        preds, target = rng.rand(n, L), rng.randint(0, 2, (n, L))
    preds = np.round(preds, 2).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    return preds, target


def task_kwargs(task):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(task, {})


# ------------------------------------------------------------ the selections


def _curve(rng, n, with_nan_primary=False):
    primary = np.round(rng.rand(n), 1).astype(np.float32)  # ties in the primary
    secondary = np.round(rng.rand(n), 1).astype(np.float32)
    thresholds = np.sort(np.round(rng.rand(n), 2)).astype(np.float32)
    if with_nan_primary:
        primary[:] = np.nan
    return primary, secondary, thresholds


@pytest.mark.parametrize("min_secondary", [0.0, 0.3, 0.7, 0.7000000001, 0.95, 1.0])
@pytest.mark.parametrize("seed", range(4))
def test_lexicographic_best_bit_equal_to_the_jax_eager_branch(seed, min_secondary):
    rng = np.random.RandomState(seed)
    for n, nan in ((1, False), (9, False), (40, False), (12, True)):
        p, s, t = _curve(rng, n, nan)
        want = jax_best(p, s, t, min_secondary)  # numpy inputs: the host branch
        got = _lexicographic_best(torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(t), min_secondary)
        assert_bit_equal(got, want)
        # the exact layout: rows in descending order, curve points masked, padding rows between them
        keep = np.repeat(np.arange(n), 2)[::-1].copy()
        point = torch.from_numpy(np.tile([False, True], n))
        got = _lexicographic_best(
            torch.from_numpy(p[keep]), torch.from_numpy(s[keep]), torch.from_numpy(t[keep]), min_secondary,
            point=point, descending=True,
        )
        assert_bit_equal(got, want)


@pytest.mark.parametrize("min_sensitivity", [0.2, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", range(3))
def test_specificity_selection_bit_equal_to_the_jax_eager_branch(seed, min_sensitivity):
    rng = np.random.RandomState(10 + seed)
    spec, sens, thr = _curve(rng, 30)
    want = jax_spec(spec, sens, thr, min_sensitivity)
    got = _specificity_at_sensitivity(torch.from_numpy(spec), torch.from_numpy(sens), torch.from_numpy(thr),
                                      min_sensitivity)
    assert_bit_equal(got, want)


def test_cutoff_is_the_smallest_float32_at_least_the_bound():
    for value in (0.0, 0.1, 0.5, 0.7, 0.9, 1.0, 1 / 3):
        cutoff = _smallest_f32_at_least(value)
        assert cutoff.dtype == np.float32 and float(cutoff) >= value
        assert float(np.nextafter(cutoff, np.float32(-np.inf), dtype=np.float32)) < value


# --------------------------------------------------------------- functionals


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("thresholds", [None, 7])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
def test_fixed_point_functionals(family, task, thresholds, ignore_index):
    stem, _, arg = family
    rng = np.random.RandomState(len(stem) + len(task) + (thresholds or 0))
    preds, target = inputs(task, rng, ignore_index=ignore_index)
    for value in (0.0, 0.5, 0.8):
        kwargs = {arg: value, "thresholds": thresholds, "ignore_index": ignore_index, **task_kwargs(task)}
        want = getattr(jf, f"{task}_{stem}")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        got = getattr(tf, f"{task}_{stem}")(preds, target, device="cpu", **kwargs)
        assert_bit_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
def test_fixed_point_dispatchers(family):
    stem, _, arg = family
    rng = np.random.RandomState(3)
    dispatch = "specicity_at_sensitivity" if stem == "specificity_at_sensitivity" else stem
    for task in ("binary", "multiclass", "multilabel"):
        preds, target = inputs(task, rng)
        kwargs = {arg: 0.5, **task_kwargs(task)}
        want = getattr(jf, dispatch)(jnp.asarray(preds), jnp.asarray(target), task, **kwargs)
        got = getattr(tf, dispatch)(preds, target, task, device="cpu", **kwargs)
        assert_bit_equal(got, want)
    with pytest.raises(ValueError, match="num_classes"):
        getattr(tf, dispatch)(preds, target, "multiclass", **{arg: 0.5}, device="cpu")
    assert tf.specificity_at_sensitivity is tf.specicity_at_sensitivity


def test_no_positives_and_no_negatives():
    """Degenerate curves: recall 0/0 = NaN everywhere, a class with no negatives."""
    preds = np.array([0.1, 0.4, 0.4, 0.9], np.float32)
    for target in (np.zeros(4, np.int64), np.ones(4, np.int64)):
        for fn in ("binary_recall_at_fixed_precision", "binary_precision_at_fixed_recall",
                   "binary_specificity_at_sensitivity"):
            for value in (0.0, 0.5):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # the ROC's warnings for an absent class
                    want = getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), value)
                    got = getattr(tf, fn)(preds, target, value, device="cpu")
                assert_bit_equal(got, want)


def test_exact_fixed_points_run_one_scan_per_curve(monkeypatch):
    calls = []
    plain = segment._plain_multi_scan
    monkeypatch.setattr(segment, "_plain_multi_scan", lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.RandomState(5)
    preds, target = inputs("multiclass", rng)
    tf.multiclass_recall_at_fixed_precision(preds, target, C, 0.5, device="cpu")
    assert len(calls) == C
    preds, target = inputs("binary", rng)
    tf.binary_specificity_at_sensitivity(preds, target, 0.5, device="cpu")
    assert len(calls) == C + 1


# ------------------------------------------------------------------- classes


# exact mode with list states and with ``CatBuffer`` states, and binned mode (no cat state)
@pytest.mark.parametrize("thresholds, cat_capacity", [(None, None), (None, 256), (9, None)])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", FAMILIES, ids=lambda f: f[0])
def test_fixed_point_classes(family, task, thresholds, cat_capacity):
    _, name, arg = family
    prefix = task.capitalize()
    kwargs = {arg: 0.5, "thresholds": thresholds, "ignore_index": -1, **task_kwargs(task)}
    jax_metric = getattr(jc, prefix + name)(**kwargs)
    extra = {} if cat_capacity is None else {"cat_capacity": cat_capacity}
    torch_metric = getattr(tc, prefix + name)(device="cpu", **kwargs, **extra)
    rng = np.random.RandomState(len(name) + len(task))
    for _ in range(3):
        preds, target = inputs(task, rng, n=40, ignore_index=-1)
        assert_bit_equal(torch_metric(preds, target), jax_metric(jnp.asarray(preds), jnp.asarray(target)))
    assert_bit_equal(torch_metric.compute(), jax_metric.compute())
    dispatcher = getattr(tc, name)(task, **kwargs, device="cpu")
    assert type(dispatcher).__name__ == prefix + name


# ----------------------------------------------------------------------- auc


@pytest.mark.parametrize("reorder", [False, True])
def test_auc(reorder):
    rng = np.random.RandomState(7)
    for x in (np.sort(rng.rand(20)), np.sort(rng.rand(20))[::-1], rng.rand(20)):
        if not reorder and not (np.all(np.diff(x) >= 0) or np.all(np.diff(x) <= 0)):
            continue
        x, y = x.astype(np.float32), rng.rand(20).astype(np.float32)
        want = np.asarray(jax_auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder))
        got = auc(torch.from_numpy(x.copy()), torch.from_numpy(y), reorder=reorder)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="1d"):
        auc(torch.ones(2, 2), torch.ones(2, 2))
    with pytest.raises(ValueError, match="same length"):
        auc(torch.ones(3), torch.ones(2))
