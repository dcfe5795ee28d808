"""The classification metric classes of metrics_tpu_torch against metrics_tpu, on the CPU.

Three batches of the same seeded numpy inputs go through each class of the JAX
package and of the port (``device="cpu"``): ``forward`` must return the same batch
values and ``compute`` the same result, counts bit-equal and float results within
rtol 1e-6, atol 1e-6. Also covered: ``reset``, ``merge_state``, a ``state_dict``
round trip, ``load_jax_state``, and the device rules of the port's ``Metric``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.ops import histogram

C, L = 4, 3


def assert_close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


def batches(task, seed=0, n=3, ignore_index=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if task == "binary":
            preds, target = rng.rand(16, 5).astype(np.float32), rng.randint(0, 2, (16, 5))
        elif task == "multiclass":
            preds, target = rng.randn(16, C, 5).astype(np.float32), rng.randint(0, C, (16, 5))
        else:
            preds, target = rng.randn(16, L, 5).astype(np.float32), rng.randint(0, 2, (16, L, 5))
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.15] = ignore_index
        out.append((preds, target))
    return out


CASES = [
    ("StatScores", "binary", {}),
    ("StatScores", "multiclass", {"average": "macro"}),
    ("StatScores", "multiclass", {"average": "micro", "ignore_index": 255}),
    ("StatScores", "multilabel", {"average": "none", "multidim_average": "samplewise"}),
    ("Accuracy", "binary", {"ignore_index": -1}),
    ("Accuracy", "multiclass", {"average": "micro"}),
    ("Accuracy", "multiclass", {"average": "macro", "ignore_index": 255}),
    ("Accuracy", "multiclass", {"average": "weighted", "top_k": 2}),
    ("Accuracy", "multiclass", {"average": "macro", "multidim_average": "samplewise", "ignore_index": 1}),
    ("Accuracy", "multilabel", {"average": "macro"}),
    ("Precision", "multiclass", {"average": "macro", "ignore_index": 255}),
    ("Precision", "multilabel", {"average": "micro"}),
    ("Recall", "binary", {}),
    ("Recall", "multiclass", {"average": "none", "ignore_index": 0}),
    ("F1Score", "multiclass", {"average": "macro", "ignore_index": 255}),
    ("F1Score", "multilabel", {"average": "weighted"}),
    ("FBetaScore", "multiclass", {"beta": 2.0, "average": "micro"}),
    ("FBetaScore", "binary", {"beta": 0.5}),
    ("ConfusionMatrix", "binary", {"normalize": "true"}),
    ("ConfusionMatrix", "multiclass", {"ignore_index": 255}),
    ("ConfusionMatrix", "multiclass", {"ignore_index": 1, "normalize": "all"}),
    ("ConfusionMatrix", "multilabel", {"ignore_index": -1}),
    ("JaccardIndex", "binary", {}),
    ("JaccardIndex", "multiclass", {"ignore_index": 255}),
    ("JaccardIndex", "multiclass", {"average": "micro", "ignore_index": 2}),
    ("JaccardIndex", "multiclass", {"average": "weighted"}),
    ("JaccardIndex", "multilabel", {"average": "macro"}),
]


def make(name, task, kwargs, device=None):
    counts = {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}.get(task, {})
    if device is None:
        return getattr(jc, name)(task=task, **counts, **kwargs)
    return getattr(tc, name)(task=task, **counts, **kwargs, device=device)


@pytest.mark.parametrize("name, task, kwargs", CASES)
def test_class_matches_jax_over_three_batches(name, task, kwargs):
    jm, tm = make(name, task, kwargs), make(name, task, kwargs, "cpu")
    assert type(tm).__name__ == type(jm).__name__
    for preds, target in batches(task, ignore_index=kwargs.get("ignore_index")):
        assert_close(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)))
    assert_close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name, task, kwargs", CASES[:: 3])
def test_reset_restores_defaults(name, task, kwargs):
    tm = make(name, task, kwargs, "cpu")
    data = batches(task, seed=1, ignore_index=kwargs.get("ignore_index"))
    first = None
    for preds, target in data:
        tm.update(preds, target)
        first = tm.compute() if first is None else first
    tm.reset()
    assert tm._update_count == 0
    for state, default in tm._defaults.items():
        value = getattr(tm, state)
        assert value == [] if isinstance(default, list) else torch.equal(value, default)
    tm.update(*data[0])
    assert_close(tm.compute(), first)


@pytest.mark.parametrize("name, task, kwargs", [c for c in CASES if c[2].get("multidim_average") != "samplewise"][:: 2])
def test_merge_state_equals_one_metric_over_all_batches(name, task, kwargs):
    data = batches(task, seed=2, ignore_index=kwargs.get("ignore_index"))
    a, b, whole = (make(name, task, kwargs, "cpu") for _ in range(3))
    for preds, target in data[:2]:
        a.update(preds, target)
    b.update(*data[2])
    for preds, target in data:
        whole.update(preds, target)
    a.merge_state(b)
    assert a._update_count == 3
    assert_close(a.compute(), whole.compute())


def test_merge_state_keeps_cat_lists_and_refuses_mismatched_registries():
    kwargs = {"average": "none", "multidim_average": "samplewise"}
    a, b = make("StatScores", "multiclass", kwargs, "cpu"), make("StatScores", "multiclass", kwargs, "cpu")
    data = batches("multiclass", seed=3)
    a.update(*data[0])
    b.update(*data[1])
    a.merge_state(b)
    assert len(a.tp) == 2
    with pytest.raises(Exception, match="registries differ"):
        a.merge_state(make("ConfusionMatrix", "multiclass", {}, "cpu"))


@pytest.mark.parametrize("name, task, kwargs", CASES[1:: 4])
def test_state_dict_round_trip(name, task, kwargs):
    data = batches(task, seed=4, ignore_index=kwargs.get("ignore_index"))
    src, dst = make(name, task, kwargs, "cpu"), make(name, task, kwargs, "cpu")
    for preds, target in data:
        src.update(preds, target)
    assert src.state_dict() == {}  # states are not persistent by default, as in metrics_tpu
    src.persistent(True)
    state = src.state_dict()
    assert set(state) == set(src._defaults)
    dst.load_state_dict(state)
    dst._update_count = src._update_count
    assert_close(dst.compute(), src.compute())


@pytest.mark.parametrize("name, task, kwargs", CASES)
def test_load_jax_state_continues_a_jax_run(name, task, kwargs):
    data = batches(task, seed=5, n=2, ignore_index=kwargs.get("ignore_index"))
    jm = make(name, task, kwargs)
    jm.update(jnp.asarray(data[0][0]), jnp.asarray(data[0][1]))
    jm.persistent(True)
    tm = load_jax_state(make(name, task, kwargs, "cpu"), jm.state_dict())
    tm.update(*data[1])
    jm.update(jnp.asarray(data[1][0]), jnp.asarray(data[1][1]))
    assert_close(tm.compute(), jm.compute())
    for state, default in tm._defaults.items():
        if not isinstance(default, list):
            assert getattr(tm, state).dtype == default.dtype  # float32 counts came across as int64


def test_load_jax_state_refuses_fractional_counts():
    tm = tc.MulticlassConfusionMatrix(num_classes=2, device="cpu")
    with pytest.raises(ValueError):
        load_jax_state(tm, {"confmat": np.array([[0.5, 1.0], [1.0, 0.0]], np.float32)})


def test_forward_full_state_strategy_matches_reduce_state():
    class FullState(tc.MulticlassAccuracy):
        full_state_update = True

    full, reduce = FullState(num_classes=C, device="cpu"), tc.MulticlassAccuracy(num_classes=C, device="cpu")
    for preds, target in batches("multiclass", seed=6):
        assert_close(full(preds, target), reduce(preds, target))
    assert_close(full.compute(), reduce.compute())


def test_readme_example_and_the_128_class_entry():
    rng = np.random.RandomState(7)
    jm, tm = jc.Accuracy(task="multiclass", num_classes=5), tc.Accuracy(task="multiclass", num_classes=5, device="cpu")
    jw = jc.MulticlassAccuracy(num_classes=128, average="macro")
    tw = tc.MulticlassAccuracy(num_classes=128, average="macro", device="cpu")
    for _ in range(3):
        preds, target = rng.randn(64, 5).astype(np.float32), rng.randint(0, 5, 64)
        assert_close(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)))
        logits, labels = rng.randn(1024, 128).astype(np.float32), rng.randint(0, 128, 1024)
        tw.update(logits, labels)
        jw.update(jnp.asarray(logits), jnp.asarray(labels))
    assert_close(tm.compute(), jm.compute())
    assert_close(tw.compute(), jw.compute())


def test_cityscapes_shaped_path_at_small_size():
    """19 classes, ignore label 255 out of range, (N, C, H, W) logits: the chip path."""
    rng = np.random.RandomState(8)
    kwargs = {"num_classes": 19, "ignore_index": 255}
    pairs = [
        (jc.MulticlassAccuracy(average="macro", **kwargs), tc.MulticlassAccuracy(average="macro", device="cpu", **kwargs)),
        (jc.MulticlassF1Score(average="macro", **kwargs), tc.MulticlassF1Score(average="macro", device="cpu", **kwargs)),
        (jc.MulticlassJaccardIndex(**kwargs), tc.MulticlassJaccardIndex(device="cpu", **kwargs)),
        (jc.MulticlassConfusionMatrix(**kwargs), tc.MulticlassConfusionMatrix(device="cpu", **kwargs)),
    ]
    for _ in range(3):
        logits = rng.randn(2, 19, 8, 16).astype(np.float32)
        target = rng.randint(0, 19, (2, 8, 16))
        target[rng.rand(*target.shape) < 0.05] = 255
        for jm, tm in pairs:
            jm.update(jnp.asarray(logits), jnp.asarray(target))
            tm.update(logits, target)
    for jm, tm in pairs:
        assert_close(tm.compute(), jm.compute())
    assert pairs[3][1].confmat.dtype == torch.int64


def test_metric_device_rules():
    with pytest.raises(ValueError, match="Unexpected keyword"):
        tc.MulticlassAccuracy(num_classes=3, device="cpu", dist_sync_on_step=True)
    tm = tc.MulticlassAccuracy(num_classes=3, device="cpu")
    assert tm.device == torch.device("cpu")
    tm.update(torch.tensor([0, 1]), np.array([0, 2]))  # array-likes go to the metric's device
    assert tm.tp.device.type == "cpu"
    meta = torch.empty(2, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="is on meta"):
        tm.update(meta, meta)


def test_functional_device_rules():
    import metrics_tpu_torch.functional.classification as tf

    out = tf.multiclass_accuracy(np.array([0, 1]), np.array([0, 1]), num_classes=3, device="cpu")
    assert out.device.type == "cpu"
    assert tf.multiclass_accuracy(torch.tensor([0, 1]), torch.tensor([0, 1]), num_classes=3).device.type == "cpu"
    with pytest.raises(RuntimeError):
        tf.multiclass_accuracy(torch.tensor([0, 1]), torch.tensor([0, 1]), num_classes=3, device="meta")


def test_cpu_run_launches_no_kernel():
    before = histogram.histogram_cuda.launches
    m = tc.MulticlassConfusionMatrix(num_classes=C, device="cpu")
    for preds, target in batches("multiclass", seed=9):
        m.update(preds, target)
    m.compute()
    assert histogram.histogram_cuda.launches == before


def test_clone_and_pickle_keep_state():
    import pickle

    tm = tc.MulticlassF1Score(num_classes=C, device="cpu")
    for preds, target in batches("multiclass", seed=10):
        tm.update(preds, target)
    for copy in (tm.clone(), pickle.loads(pickle.dumps(tm))):
        assert_close(copy.compute(), tm.compute())
        copy.update(*batches("multiclass", seed=11, n=1)[0])  # the update wrapper survives the copy
        assert copy._update_count == tm._update_count + 1
