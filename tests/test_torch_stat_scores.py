"""Stat scores of metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy inputs, drawn from a seeded ``np.random.RandomState``, go through the
JAX functions and the port's (``device="cpu"``). Integer results (the counts) must be
bit-equal; averaged results, which are float32 in both, agree within 1e-6.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.functional.classification as tf
# the modules, not the functions of the same name that the packages export
jax_ss = importlib.import_module("metrics_tpu.functional.classification.stat_scores")
torch_ss = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")

NUM_CLASSES = 5


def assert_same(got, want, exact):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got.astype(np.float64), want.astype(np.float64))
    else:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


def _binary_inputs(rng, kind, shape=(6, 7)):
    target = rng.randint(0, 2, shape)
    if kind == "labels":
        preds = rng.randint(0, 2, shape)
    elif kind == "probs":
        preds = rng.rand(*shape).astype(np.float32)
    else:  # logits: sigmoid is applied first
        preds = (rng.randn(*shape) * 3).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("kind", ["labels", "probs", "logits"])
def test_binary_stat_scores(kind, ignore_index, multidim_average):
    rng = np.random.RandomState(1)
    preds, target = _binary_inputs(rng, kind)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    want = jf.binary_stat_scores(
        jnp.asarray(preds), jnp.asarray(target), multidim_average=multidim_average, ignore_index=ignore_index
    )
    got = tf.binary_stat_scores(preds, target, multidim_average=multidim_average, ignore_index=ignore_index, device="cpu")
    assert_same(got, want, exact=True)


def _multiclass_inputs(rng, kind, n=40, extra=None):
    shape = (n,) if extra is None else (n, extra)
    target = rng.randint(0, NUM_CLASSES, shape)
    if kind == "labels":
        preds = rng.randint(0, NUM_CLASSES, shape)
    elif kind == "probs":
        p = rng.rand(n, NUM_CLASSES, *([] if extra is None else [extra])).astype(np.float32)
        preds = p / p.sum(1, keepdims=True)
    else:
        preds = rng.randn(n, NUM_CLASSES, *([] if extra is None else [extra])).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("ignore_index", [None, 1, 255])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("kind", ["labels", "logits"])
def test_multiclass_stat_scores_global(kind, average, ignore_index):
    rng = np.random.RandomState(2)
    preds, target = _multiclass_inputs(rng, kind)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    kwargs = dict(num_classes=NUM_CLASSES, average=average, ignore_index=ignore_index)
    want = jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multiclass_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=average in ("micro", "none"))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("ignore_index", [None, 1, 255])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_multiclass_stat_scores_samplewise(average, ignore_index, top_k):
    rng = np.random.RandomState(3)
    preds, target = _multiclass_inputs(rng, "probs" if top_k > 1 else "labels", n=6, extra=9)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    kwargs = dict(
        num_classes=NUM_CLASSES, average=average, top_k=top_k, multidim_average="samplewise", ignore_index=ignore_index
    )
    want = jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multiclass_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=average != "macro")


@pytest.mark.parametrize("ignore_index", [None, 2, 255])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_multiclass_top_k_global(average, ignore_index):
    rng = np.random.RandomState(4)
    preds, target = _multiclass_inputs(rng, "probs")
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    kwargs = dict(num_classes=NUM_CLASSES, average=average, top_k=3, ignore_index=ignore_index)
    want = jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multiclass_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=average != "macro")


@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_argmax_ties_take_the_first_index_and_nan_is_maximal(average):
    # rows: an exact three-way tie, a NaN after the maximum, a NaN first, all equal
    preds = np.array(
        [
            [0.1, 0.3, 0.3, 0.3, 0.0],
            [0.9, 0.1, np.nan, 0.2, 0.0],
            [np.nan, 5.0, 1.0, 0.0, np.nan],
            [0.2, 0.2, 0.2, 0.2, 0.2],
        ],
        np.float32,
    )
    target = np.array([1, 2, 0, 0])
    kwargs = dict(num_classes=NUM_CLASSES, average=average)
    want = jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multiclass_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=average != "macro")
    if average == "micro":
        assert got[0].item() == 4  # every row hits: first index of a tie, NaN maximal


def test_top_k_ties_take_the_lower_index():
    preds = np.array([[0.3, 0.3, 0.3, 0.05, 0.05], [0.1, 0.2, 0.2, 0.2, 0.3]], np.float32)
    target = np.array([2, 3])
    kwargs = dict(num_classes=NUM_CLASSES, average="none", top_k=2)
    want = jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multiclass_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=True)


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_micro_tn_is_widened_to_the_count_dtype(ignore_index):
    rng = np.random.RandomState(5)
    preds, target = _multiclass_inputs(rng, "logits")
    if ignore_index is not None:
        target[:5] = ignore_index
    tp, fp, tn, fn = torch_ss._multiclass_stat_scores_format_update(
        torch.from_numpy(preds), torch.from_numpy(target), NUM_CLASSES, average="micro", ignore_index=ignore_index
    )
    assert tn.dtype == torch.int64 and tp.dtype == torch.int64
    jtp, jfp, jtn, jfn = jax_ss._multiclass_stat_scores_format_update(
        jnp.asarray(preds), jnp.asarray(target), NUM_CLASSES, average="micro", ignore_index=ignore_index
    )
    for g, w in zip((tp, fp, tn, fn), (jtp, jfp, jtn, jfn)):
        assert_same(g, w, exact=True)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("kind", ["labels", "probs", "logits"])
def test_multilabel_stat_scores(kind, average, ignore_index, multidim_average):
    rng = np.random.RandomState(6)
    preds, target = _binary_inputs(rng, kind, shape=(6, 3, 4))
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.2] = ignore_index
    kwargs = dict(num_labels=3, average=average, multidim_average=multidim_average, ignore_index=ignore_index)
    want = jf.multilabel_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.multilabel_stat_scores(preds, target, device="cpu", **kwargs)
    assert_same(got, want, exact=average in ("micro", "none"))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_dispatcher(task):
    rng = np.random.RandomState(7)
    if task == "multiclass":
        preds, target = _multiclass_inputs(rng, "labels")
    else:
        preds, target = _binary_inputs(rng, "probs", shape=(8, 3))
    kwargs = dict(task=task, num_classes=NUM_CLASSES, num_labels=3)
    assert_same(tf.stat_scores(preds, target, device="cpu", **kwargs),
                jf.stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs), exact=True)


def test_validation_errors_match():
    target = np.array([0, 1, 7])
    with pytest.raises(RuntimeError):
        tf.binary_stat_scores(np.array([0, 1, 1]), target, device="cpu")
    with pytest.raises(RuntimeError):
        tf.multiclass_stat_scores(np.array([0, 1, 2]), np.array([0, 1, 2, 3, 4, 5])[:3] * 3, num_classes=2, device="cpu")
    with pytest.raises(ValueError):
        tf.multiclass_stat_scores(np.array([0, 1]), np.array([0, 1]), num_classes=3, top_k=4, device="cpu")


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("num_classes", [2, 19, 128])
def test_confusion_counts_clip_labels_and_drop_masked_rows(num_classes, masked):
    from metrics_tpu.ops.confmat import confusion_counts as jax_counts
    from metrics_tpu_torch.ops.confmat import confusion_counts

    rng = np.random.RandomState(num_classes)
    preds = rng.randint(-2, num_classes + 2, 3000)  # out-of-range labels are clipped
    target = rng.randint(-2, num_classes + 2, 3000)
    valid = rng.rand(3000) < 0.8 if masked else np.ones(3000, bool)
    want = jax_counts(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), num_classes)
    got = confusion_counts(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid) if masked else None, num_classes
    )
    assert got.dtype == torch.int64
    assert_same(got, want, exact=True)


def test_streaming_counts_match():
    from metrics_tpu.ops import streaming as jax_streaming
    from metrics_tpu_torch.ops import streaming

    rng = np.random.RandomState(9)
    preds, target = rng.randint(0, 4, 5000), rng.randint(0, 4, 5000)
    probs, valid = rng.rand(5000, 4).astype(np.float32), rng.rand(5000) < 0.9
    assert_same(streaming.eq_count(torch.from_numpy(preds), torch.from_numpy(target)),
                jax_streaming.eq_count(jnp.asarray(preds), jnp.asarray(target)), exact=True)
    assert_same(
        streaming.argmax_correct_count(torch.from_numpy(probs), torch.from_numpy(target), torch.from_numpy(valid)),
        jax_streaming.argmax_correct_count(jnp.asarray(probs), jnp.asarray(target), jnp.asarray(valid)),
        exact=True,
    )
