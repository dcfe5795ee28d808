"""Specificity, Hamming distance, Cohen's kappa, Matthews' correlation and exact match
of metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy inputs, drawn from a seeded ``np.random.RandomState``, go through the
JAX package and the port (``device="cpu"``): the functionals on one batch, the
classes over three batches of ``forward`` and a ``compute``. Results that are counts
or exact ratios of counts compare by value; float results within rtol 1e-6, atol
1e-6 (the JAX package computes in float32 from float32 counts, the port from int64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from tests.torch_deadline import deadline  # noqa: F401

C, L = 5, 3


def assert_close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


def inputs(task, rng, kind="probs", n=24, extra=4, ignore_index=None):
    if task == "binary":
        preds = rng.randint(0, 2, (n, extra)) if kind == "labels" else rng.rand(n, extra).astype(np.float32)
        target = rng.randint(0, 2, (n, extra))
    elif task == "multiclass":
        if kind == "labels":
            preds = rng.randint(0, C, (n, extra))
        else:
            preds = rng.randn(n, C, extra).astype(np.float32)
        target = rng.randint(0, C, (n, extra))
    else:
        preds = rng.randint(0, 2, (n, L, extra)) if kind == "labels" else rng.rand(n, L, extra).astype(np.float32)
        target = rng.randint(0, 2, (n, L, extra))
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    return preds, target


def counts_for(task):
    return {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(task, {})


# ---------------------------------------------------------------- functionals

STAT_FUNCTIONALS = ["specificity", "hamming_distance"]


# binary takes no ``average``: one case each
STAT_GRID = [
    (task, average)
    for task in ("binary", "multiclass", "multilabel")
    for average in (["micro"] if task == "binary" else ["micro", "macro", "weighted", "none"])
]


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, 1])
@pytest.mark.parametrize("task, average", STAT_GRID)
@pytest.mark.parametrize("name", STAT_FUNCTIONALS)
def test_stat_scores_functionals(name, task, average, ignore_index, multidim_average):
    rng = np.random.RandomState(len(name) + 7 * len(task))
    ii = None if ignore_index is None else (-1 if task != "multiclass" else ignore_index)
    preds, target = inputs(task, rng, ignore_index=ii)
    kwargs = dict(multidim_average=multidim_average, ignore_index=ii, **counts_for(task))
    if task != "binary":
        kwargs["average"] = average
    fn = f"{task}_{name}"
    want = getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, fn)(preds, target, device="cpu", **kwargs)
    assert_close(got, want)


@pytest.mark.parametrize("name", STAT_FUNCTIONALS)
def test_stat_scores_functional_top_k(name):
    rng = np.random.RandomState(11)
    preds, target = inputs("multiclass", rng, ignore_index=255)
    kwargs = dict(num_classes=C, average="macro", top_k=2, ignore_index=255)
    want = getattr(jf, f"multiclass_{name}")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert_close(getattr(tf, f"multiclass_{name}")(preds, target, device="cpu", **kwargs), want)


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("ignore_index", [None, 255])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_cohen_kappa(task, ignore_index, weights):
    rng = np.random.RandomState(3)
    preds, target = inputs(task, rng, ignore_index=ignore_index)
    kwargs = dict(weights=weights, ignore_index=ignore_index, **counts_for(task))
    want = getattr(jf, f"{task}_cohen_kappa")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert_close(getattr(tf, f"{task}_cohen_kappa")(preds, target, device="cpu", **kwargs), want)
    dispatched = tf.cohen_kappa(preds, target, task=task, device="cpu", **kwargs)
    assert_close(dispatched, want)


@pytest.mark.parametrize("kind", ["labels", "probs"])
@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_matthews_corrcoef(task, ignore_index, kind):
    rng = np.random.RandomState(4)
    ii = None if ignore_index is None else (-1 if task != "multiclass" else ignore_index)
    preds, target = inputs(task, rng, kind=kind, ignore_index=ii)
    kwargs = dict(ignore_index=ii, **counts_for(task))
    want = getattr(jf, f"{task}_matthews_corrcoef")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert_close(getattr(tf, f"{task}_matthews_corrcoef")(preds, target, device="cpu", **kwargs), want)


def test_matthews_corrcoef_degenerate_inputs():
    # one class only in both: the JAX package's (and its reference's) special cases
    for preds, target in ((np.zeros(8, np.int64), np.zeros(8, np.int64)), (np.ones(8, np.int64), np.ones(8, np.int64)),
                          (np.zeros(8, np.int64), np.ones(8, np.int64))):
        want = jf.binary_matthews_corrcoef(jnp.asarray(preds), jnp.asarray(target))
        assert_close(tf.binary_matthews_corrcoef(preds, target, device="cpu"), want)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, 2])
@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_exact_match(task, ignore_index, multidim_average):
    rng = np.random.RandomState(5)
    ii = None if ignore_index is None else (-1 if task == "multilabel" else ignore_index)
    # few positions per sample, so that some samples match exactly
    preds, target = inputs(task, rng, kind="labels", extra=2, ignore_index=ii)
    if task == "multiclass":
        preds = np.where(rng.rand(*preds.shape) < 0.6, target, preds)
    kwargs = dict(multidim_average=multidim_average, ignore_index=ii, **counts_for(task))
    want = getattr(jf, f"{task}_exact_match")(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, f"{task}_exact_match")(preds, target, device="cpu", **kwargs)
    assert_close(got, want)
    assert_close(tf.exact_match(preds, target, task=task, device="cpu", **kwargs), want)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_dispatchers(task):
    rng = np.random.RandomState(6)
    preds, target = inputs(task, rng)
    kwargs = dict(task=task, num_classes=C, num_labels=L)
    for name in ("specificity", "hamming_distance", "matthews_corrcoef"):
        want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        assert_close(getattr(tf, name)(preds, target, device="cpu", **kwargs), want)


# -------------------------------------------------------------------- classes

CLASS_CASES = [
    ("Specificity", "binary", {}),
    ("Specificity", "multiclass", {"average": "macro", "ignore_index": 255}),
    ("Specificity", "multiclass", {"average": "none", "multidim_average": "samplewise"}),
    ("Specificity", "multilabel", {"average": "micro", "ignore_index": -1}),
    ("HammingDistance", "binary", {"ignore_index": -1}),
    ("HammingDistance", "multiclass", {"average": "micro"}),
    ("HammingDistance", "multiclass", {"average": "weighted", "top_k": 2}),
    ("HammingDistance", "multilabel", {"average": "macro", "multidim_average": "samplewise"}),
    ("CohenKappa", "binary", {"weights": "linear"}),
    ("CohenKappa", "multiclass", {"ignore_index": 255}),
    ("CohenKappa", "multiclass", {"weights": "quadratic", "ignore_index": 1}),
    ("MatthewsCorrCoef", "binary", {}),
    ("MatthewsCorrCoef", "multiclass", {"ignore_index": 255}),
    ("MatthewsCorrCoef", "multilabel", {"ignore_index": -1}),
    ("ExactMatch", "multiclass", {}),
    ("ExactMatch", "multiclass", {"ignore_index": 255}),
    ("ExactMatch", "multilabel", {"ignore_index": -1}),
]


def make(name, task, kwargs, device=None):
    if device is None:
        return getattr(jc, name)(task=task, **counts_for(task), **kwargs)
    return getattr(tc, name)(task=task, **counts_for(task), **kwargs, device=device)


def class_batches(task, kwargs, seed, n=3):
    rng = np.random.RandomState(seed)
    return [inputs(task, rng, extra=2, ignore_index=kwargs.get("ignore_index")) for _ in range(n)]


@pytest.mark.parametrize("name, task, kwargs", CLASS_CASES)
def test_class_matches_jax_over_three_batches(name, task, kwargs):
    jm, tm = make(name, task, kwargs), make(name, task, kwargs, "cpu")
    assert type(tm).__name__ == type(jm).__name__
    for preds, target in class_batches(task, kwargs, seed=8):
        assert_close(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)))
    assert_close(tm.compute(), jm.compute())
    tm.reset()
    preds, target = class_batches(task, kwargs, seed=9, n=1)[0]
    tm.update(preds, target)
    jm.reset()
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
def test_samplewise_exact_match_over_updates(task):
    # compared through update alone: the JAX package's samplewise ``total`` is a
    # ``sum`` state, which forward turns into 2 (queue C of the roadmap); the port
    # keeps it at 1 by a ``max`` reduction
    kwargs = {"multidim_average": "samplewise"}
    jm, tm = make("ExactMatch", task, kwargs), make("ExactMatch", task, kwargs, "cpu")
    for preds, target in class_batches(task, kwargs, seed=10):
        tm.update(preds, target)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(tm.compute(), jm.compute())
    fwd = make("ExactMatch", task, kwargs, "cpu")
    for preds, target in class_batches(task, kwargs, seed=10):
        fwd(preds, target)
    assert_close(fwd.compute(), jm.compute())
    assert tm._reductions["total"] == "max"


def test_cohen_kappa_and_matthews_join_the_confusion_matrix_update():
    from metrics_tpu_torch.classification import MulticlassConfusionMatrix

    for cls in (tc.MulticlassCohenKappa, tc.MulticlassMatthewsCorrCoef):
        assert cls.update is MulticlassConfusionMatrix.update
    for cls in (tc.MulticlassSpecificity, tc.MulticlassHammingDistance):
        assert cls.update is tc.MulticlassStatScores.update


def test_dispatchers_refuse_unknown_tasks():
    with pytest.raises(ValueError):
        tc.CohenKappa(task="multilabel", num_classes=3, device="cpu")
    with pytest.raises(ValueError):
        tc.ExactMatch(task="binary", device="cpu")
    with pytest.raises(ValueError):
        tc.MulticlassCohenKappa(num_classes=3, weights="cubic", device="cpu")
