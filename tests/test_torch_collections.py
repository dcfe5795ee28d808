"""MetricCollection of metrics_tpu_torch against metrics_tpu, on the CPU.

The eight compute-group cases of the JAX package's own matrix
(``tests/unittests/bases/test_compute_groups.py``) are built in both packages from
the same constructor arguments: the port's ``compute_groups`` partition must equal
the JAX one, and over two epochs of two batches with a ``reset`` between them the
values with compute groups, without them, and of the JAX collection must agree
(counts by value, floats within rtol 1e-6, atol 1e-6). Also covered: prefix and
postfix, nesting, ``forward``, ``items(copy_state=True)``, a member's ``reset``,
``state_dict``/``load_state_dict``, ``load_jax_state`` of a collection, the device
rule of the groups, ``fused=True`` against eager, a checkpoint round trip, and what
is not ported (``plot``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.core.collections as jcol
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core import MeanMetric, MetricCollection

_rng = np.random.RandomState(42)
_logits = _rng.randn(10, 3, 2).astype(np.float32)
MC_PREDS = np.exp(_logits) / np.exp(_logits).sum(1, keepdims=True)
MC_TARGET = _rng.randint(0, 3, (10, 2))
ML_PREDS = _rng.rand(10, 3).astype(np.float32)
ML_TARGET = _rng.randint(0, 2, (10, 3))


def case(index, pkg, device=None):
    """(metrics, expected groups, multilabel?) of case ``index``, built in ``pkg``."""
    kw = {} if device is None else {"device": device}
    collection = jcol.MetricCollection if pkg is jc else MetricCollection

    def m(name, **kwargs):
        return getattr(pkg, name)(**kwargs, **kw)

    if index == 0:
        return m("MulticlassAccuracy", num_classes=3), {0: ["MulticlassAccuracy"]}, False
    if index == 1:
        metrics = {"acc0": m("MulticlassAccuracy", num_classes=3), "acc1": m("MulticlassAccuracy", num_classes=3)}
        return metrics, {0: ["acc0", "acc1"]}, False
    if index == 2:
        return ([m("MulticlassPrecision", num_classes=3), m("MulticlassRecall", num_classes=3)],
                {0: ["MulticlassPrecision", "MulticlassRecall"]}, False)
    if index == 3:
        return ([m("MulticlassConfusionMatrix", num_classes=3), m("MulticlassRecall", num_classes=3)],
                {0: ["MulticlassConfusionMatrix"], 1: ["MulticlassRecall"]}, False)
    if index == 4:
        metrics = [m("MulticlassConfusionMatrix", num_classes=3), m("MulticlassCohenKappa", num_classes=3),
                   m("MulticlassRecall", num_classes=3), m("MulticlassPrecision", num_classes=3)]
        return metrics, {0: ["MulticlassConfusionMatrix", "MulticlassCohenKappa"],
                         1: ["MulticlassRecall", "MulticlassPrecision"]}, False
    if index == 5:
        metrics = {
            "acc": m("MulticlassAccuracy", num_classes=3),
            "acc2": m("MulticlassAccuracy", num_classes=3),
            "acc3": m("MulticlassAccuracy", num_classes=3, multidim_average="samplewise"),
            "f1": m("MulticlassF1Score", num_classes=3),
            "recall": m("MulticlassRecall", num_classes=3),
            "confmat": m("MulticlassConfusionMatrix", num_classes=3),
        }
        return metrics, {0: ["acc", "acc2", "f1", "recall"], 1: ["acc3"], 2: ["confmat"]}, False
    if index == 6:
        return ([m("MulticlassAUROC", num_classes=3, average="macro"),
                 m("MulticlassAveragePrecision", num_classes=3, average="macro")],
                {0: ["MulticlassAUROC", "MulticlassAveragePrecision"]}, False)
    metrics = [
        collection(m("MultilabelAUROC", num_labels=3, average="micro"),
                   m("MultilabelAveragePrecision", num_labels=3, average="micro"), postfix="_micro"),
        collection(m("MultilabelAUROC", num_labels=3, average="macro"),
                   m("MultilabelAveragePrecision", num_labels=3, average="macro"), postfix="_macro"),
    ]
    return metrics, {0: ["MultilabelAUROC_micro", "MultilabelAveragePrecision_micro", "MultilabelAUROC_macro",
                         "MultilabelAveragePrecision_macro"]}, True


IDS = ["single", "same_class", "same_update_fn", "different_families", "multi_group", "complex", "list_states",
       "nested_average_merge"]


def data(multilabel):
    return (ML_PREDS, ML_TARGET) if multilabel else (MC_PREDS, MC_TARGET)


def partition(groups):
    return {frozenset(v) for v in groups.values()}


def assert_close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


def assert_same_results(got, want):
    assert got.keys() == want.keys()
    for key in got:
        assert_close(got[key], want[key])


@pytest.mark.parametrize("prefix, postfix", [(None, None), ("prefix_", "_postfix")])
@pytest.mark.parametrize("index", range(8), ids=IDS)
def test_compute_groups_match_jax_over_two_epochs(index, prefix, postfix):
    metrics, expected, multilabel = case(index, tc, "cpu")
    grouped = MetricCollection(metrics, prefix=prefix, postfix=postfix, compute_groups=True)
    plain = MetricCollection(case(index, tc, "cpu")[0], prefix=prefix, postfix=postfix, compute_groups=False)
    reference = jcol.MetricCollection(case(index, jc)[0], prefix=prefix, postfix=postfix, compute_groups=True)

    assert partition(grouped.compute_groups) == partition(reference.compute_groups) == partition(expected)
    assert plain.compute_groups == {}
    preds, target = data(multilabel)
    for _ in range(2):  # epochs
        for _ in range(2):  # batches
            grouped.update(preds, target)
            plain.update(preds, target)
            reference.update(jnp.asarray(preds), jnp.asarray(target))
            assert partition(grouped.compute_groups) == partition(expected)
        with_groups = grouped.compute()
        assert_same_results(with_groups, plain.compute())
        assert_same_results(with_groups, reference.compute())
        if prefix:
            assert all(k.startswith(prefix) and k.endswith(postfix) for k in with_groups)
        grouped.reset()
        plain.reset()
        reference.reset()


@pytest.mark.parametrize("index", [1, 4, 5, 7], ids=[IDS[i] for i in (1, 4, 5, 7)])
def test_forward_matches_jax_and_keeps_groups(index):
    metrics, expected, multilabel = case(index, tc, "cpu")
    grouped = MetricCollection(metrics)
    plain = MetricCollection(case(index, tc, "cpu")[0], compute_groups=False)
    reference = jcol.MetricCollection(case(index, jc)[0])
    rng = np.random.RandomState(index)
    preds, target = data(multilabel)
    for _ in range(2):
        order = rng.permutation(len(preds))
        p, t = preds[order[:6]], target[order[:6]]
        batch = grouped(p, t)
        assert_same_results(batch, plain(p, t))
        assert_same_results(batch, reference(jnp.asarray(p), jnp.asarray(t)))
    assert partition(grouped.compute_groups) == partition(expected)
    assert_same_results(grouped.compute(), reference.compute())


@pytest.mark.parametrize("method", ["items", "values", "getitem"])
@pytest.mark.parametrize("index", range(6), ids=IDS[:6])
def test_compute_group_state_copies_on_access(index, method):
    grouped = MetricCollection(case(index, tc, "cpu")[0])
    plain = MetricCollection(case(index, tc, "cpu")[0], compute_groups=False)
    preds, target = data(False)
    for _ in range(2):
        grouped.update(preds, target)
        plain.update(preds, target)
    if method == "items":
        pairs = [(a, b) for (_, a), (_, b) in zip(grouped.items(), plain.items())]
    elif method == "values":
        pairs = list(zip(grouped.values(), plain.values()))
    else:
        pairs = [(grouped[k], plain[k]) for k in list(grouped.keys())]
    for a, b in pairs:  # resetting one copy must not touch its group partners
        for state in a._defaults:
            sa, sb = getattr(a, state), getattr(b, state)
            for x, y in zip(sa, sb) if isinstance(sa, list) else [(sa, sb)]:
                assert torch.equal(x, y)
        a.reset()


@pytest.mark.parametrize("index", range(8), ids=IDS)
def test_runtime_validation_agrees_with_static(index, monkeypatch):
    # METRICS_TPU_VALIDATE_COMPUTE_GROUPS=1: the first update compares every
    # metric's states, warns where that disagrees with the static groups, keeps them
    monkeypatch.setenv("METRICS_TPU_VALIDATE_COMPUTE_GROUPS", "1")
    metrics, expected, multilabel = case(index, tc, "cpu")
    validated = MetricCollection(metrics)
    plain = MetricCollection(case(index, tc, "cpu")[0], compute_groups=False)
    preds, target = data(multilabel)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a disagreement warns: fail on it
        validated.update(preds, target)
    assert partition(validated.compute_groups) == partition(expected)
    for _ in range(2):
        plain.update(preds, target)
    validated.update(preds, target)
    assert_same_results(validated.compute(), plain.compute())


def test_member_reset_splits_it_from_its_group():
    mc = MetricCollection([tc.MulticlassPrecision(num_classes=3, device="cpu"),
                           tc.MulticlassRecall(num_classes=3, device="cpu")])
    mc.update(MC_PREDS, MC_TARGET)
    mc.__getitem__("MulticlassRecall", copy_state=False).reset()
    mc.update(MC_PREDS, MC_TARGET)
    assert partition(mc.compute_groups) == {frozenset({"MulticlassPrecision"}), frozenset({"MulticlassRecall"})}
    precision = tc.MulticlassPrecision(num_classes=3, device="cpu")
    recall = tc.MulticlassRecall(num_classes=3, device="cpu")
    for _ in range(2):
        precision.update(MC_PREDS, MC_TARGET)
    recall.update(MC_PREDS, MC_TARGET)
    assert_close(mc.compute()["MulticlassPrecision"], precision.compute())
    assert_close(mc.compute()["MulticlassRecall"], recall.compute())


def test_groups_never_span_two_devices():
    on_cpu = tc.MulticlassAccuracy(num_classes=3, device="cpu")
    on_meta = tc.MulticlassAccuracy(num_classes=3, device="meta")
    mc = MetricCollection({"on_cpu": on_cpu, "on_meta": on_meta})
    assert partition(mc.compute_groups) == {frozenset({"on_cpu"}), frozenset({"on_meta"})}
    runtime_knobs = tc.MulticlassAccuracy(num_classes=3, device="cpu", dist_sync_on_step=True,
                                          sync_on_compute=False, compute_on_cpu=True)
    mc = MetricCollection({"a": tc.MulticlassAccuracy(num_classes=3, device="cpu"), "b": runtime_knobs})
    assert partition(mc.compute_groups) == {frozenset({"a", "b"})}


def test_prefix_postfix_nesting_and_clone():
    inner = MetricCollection([tc.MulticlassAccuracy(num_classes=3, device="cpu")], prefix="in_")
    mc = MetricCollection({"outer": inner, "f1": tc.MulticlassF1Score(num_classes=3, device="cpu")},
                          prefix="p_", postfix="_s")
    assert set(mc.keys(keep_base=True)) == {"outer_in_MulticlassAccuracy", "f1"}
    assert set(mc.keys()) == {"p_outer_in_MulticlassAccuracy_s", "p_f1_s"}
    assert partition(mc.compute_groups) == {frozenset({"outer_in_MulticlassAccuracy", "f1"})}
    clone = mc.clone(prefix="c_")
    assert set(clone.keys()) == {"c_outer_in_MulticlassAccuracy_s", "c_f1_s"}
    mc.update(MC_PREDS, MC_TARGET)
    assert clone["c_f1_s".removeprefix("c_").removesuffix("_s")]._update_count == 0
    accuracy = tc.MulticlassAccuracy(num_classes=3, device="cpu")
    accuracy.update(MC_PREDS, MC_TARGET)
    assert_close(mc.compute()["p_outer_in_MulticlassAccuracy_s"], accuracy.compute())
    with pytest.raises(ValueError, match="prefix"):
        MetricCollection([MeanMetric(device="cpu")], prefix=1)
    with pytest.raises(ValueError, match="two metrics"):
        MetricCollection([MeanMetric(device="cpu"), MeanMetric(device="cpu")])


def test_explicit_groups_and_late_members():
    mc = MetricCollection([tc.MulticlassPrecision(num_classes=3, device="cpu"),
                           tc.MulticlassRecall(num_classes=3, device="cpu")],
                          compute_groups=[["MulticlassPrecision"]])
    assert partition(mc.compute_groups) == {frozenset({"MulticlassPrecision"}), frozenset({"MulticlassRecall"})}
    mc.update(MC_PREDS, MC_TARGET)
    mc["late"] = tc.MulticlassF1Score(num_classes=3, device="cpu")
    assert any("late" in g for g in mc.compute_groups.values())
    mc.update(MC_PREDS, MC_TARGET)
    assert mc["late"]._update_count == 1
    with pytest.raises(ValueError, match="does not match"):
        MetricCollection([MeanMetric(device="cpu")], compute_groups=[["nope"]])


def test_state_dict_round_trip_and_to():
    src = MetricCollection(case(4, tc, "cpu")[0])
    src.update(MC_PREDS, MC_TARGET)
    src.persistent(True)
    state = src.state_dict()
    assert "MulticlassConfusionMatrix.confmat" in state and "MulticlassRecall.tp" in state
    dst = MetricCollection(case(4, tc, "cpu")[0])
    dst.persistent(True)
    dst.load_state_dict(state)
    leader, member = dst._modules["MulticlassConfusionMatrix"], dst._modules["MulticlassCohenKappa"]
    assert member.confmat is leader.confmat  # shared again after the load
    dst = dst.to("cpu")
    assert member.confmat is leader.confmat
    for metric in dst.values(copy_state=False):
        metric._update_count = 1  # the update count is not a state: it does not travel
    assert_same_results(dst.compute(), src.compute())


def test_load_jax_state_of_a_collection_continues_a_jax_run():
    jmc = jcol.MetricCollection(case(5, jc)[0])
    jmc.update(jnp.asarray(MC_PREDS), jnp.asarray(MC_TARGET))
    jmc.persistent(True)
    tmc = load_jax_state(MetricCollection(case(5, tc, "cpu")[0]), jmc.state_dict())
    leader = tmc._modules[tmc.compute_groups[0][0]]
    for name in tmc.compute_groups[0][1:]:
        assert tmc._modules[name].tp is leader.tp
    preds, target = MC_PREDS[::-1].copy(), MC_TARGET[::-1].copy()
    tmc.update(preds, target)
    jmc.update(jnp.asarray(preds), jnp.asarray(target))
    assert_same_results(tmc.compute(), jmc.compute())


def test_not_ported_parts_raise(tmp_path):
    fused = MetricCollection([MeanMetric(device="cpu")], fused=True)  # the fused engine is ported
    eager = MetricCollection([MeanMetric(device="cpu")])
    for values in (torch.arange(4.0), torch.ones(3)):
        fused.update(values)
        eager.update(values)
    assert fused.fused and torch.equal(fused.compute()["MeanMetric"], eager.compute()["MeanMetric"])
    # checkpoints are ported (tests/test_torch_ckpt.py): a round trip; plot is not
    mc = MetricCollection([MeanMetric(device="cpu")])
    mc.update(torch.arange(4.0))
    assert mc.save_checkpoint(str(tmp_path)).committed
    back = MetricCollection([MeanMetric(device="cpu")])
    assert back.restore_checkpoint(str(tmp_path)) == 0
    assert torch.equal(back.compute()["MeanMetric"], mc.compute()["MeanMetric"])
    with pytest.raises(NotImplementedError):
        mc.plot()
