"""Calibration error, hinge loss, multilabel ranking, group fairness and Dice of
metrics_tpu_torch against metrics_tpu, on the CPU; the package's exports; states
carried across with ``load_jax_state``.

The same numpy inputs, drawn from seeded ``np.random.RandomState``s, go through the
JAX package and the port (``device="cpu"``). Counts are compared bit for bit, and so
are the calibration bin boundaries (against ``jnp.linspace``); float results within
the tolerance of the JAX package's own test of the metric
(``tests/unittests/classification/test_extra_metrics.py``): atol 1e-6, 1e-5 for
the ranking metrics. The calibration counts are int32 in the port, a deliberate
deviation from the JAX package's float32 sums: equal below 2^24 samples per bin,
exact above.
"""
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.functional.classification.calibration_error import _binning_bucketize as jax_bucketize
from metrics_tpu.functional.classification.calibration_error import _ce_compute as jax_ce_compute
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_boundaries,
    _binning_bucketize,
    _ce_compute,
)
from metrics_tpu_torch.ops import histogram
from tests.torch_deadline import deadline  # noqa: F401

C, L, G = 5, 6, 4
ATOL = 1e-6
RANKING_ATOL = 1e-5


def assert_close(got, want, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=atol)


def binary_inputs(rng, n=64, logits=False):
    preds = (rng.randn(n) * 3 if logits else rng.rand(n)).astype(np.float32)
    return preds, rng.randint(0, 2, n)


def multiclass_inputs(rng, n=64, logits=True):
    preds = rng.randn(n, C).astype(np.float32)
    if not logits:
        preds = np.exp(preds) / np.exp(preds).sum(1, keepdims=True)
    return preds.astype(np.float32), rng.randint(0, C, n)


# ------------------------------------------------------------------ calibration


def test_bin_boundaries_bit_equal_to_jnp_linspace():
    for n_bins in range(1, 101):
        want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
        got = _bin_boundaries(n_bins, "cpu").numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"n_bins={n_bins}")


def test_bins_at_boundaries_and_confidence_one():
    """Confidences on every boundary, and of exactly 1.0 (the last, phantom bin)."""
    n_bins = 15
    bounds = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    conf = np.concatenate([bounds, bounds, np.nextafter(bounds, np.float32(0)), [1.0, 1.0, 0.0]]).astype(np.float32)
    acc = (np.arange(conf.size) % 3 == 0).astype(np.float32)
    want = jax_bucketize(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds))
    got = _binning_bucketize(torch.from_numpy(conf), torch.from_numpy(acc), torch.from_numpy(bounds))
    for g, w in zip(got, want):
        assert g.shape == (n_bins + 1,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_functionals(norm, ignore_index):
    rng = np.random.RandomState(len(norm))
    for n_bins in (1, 10, 15):
        for logits in (False, True):
            preds, target = binary_inputs(rng, logits=logits)
            mpreds, mtarget = multiclass_inputs(rng, logits=logits)
            if ignore_index is not None:
                target[::5] = ignore_index
                mtarget[::7] = ignore_index
            kw = dict(n_bins=n_bins, norm=norm, ignore_index=ignore_index)
            assert_close(tf.binary_calibration_error(preds, target, device="cpu", **kw),
                         jf.binary_calibration_error(jnp.asarray(preds), jnp.asarray(target), **kw))
            assert_close(tf.multiclass_calibration_error(mpreds, mtarget, C, device="cpu", **kw),
                         jf.multiclass_calibration_error(jnp.asarray(mpreds), jnp.asarray(mtarget), C, **kw))
            assert_close(tf.calibration_error(mpreds, mtarget, "multiclass", num_classes=C, device="cpu", **kw),
                         jf.calibration_error(jnp.asarray(mpreds), jnp.asarray(mtarget), "multiclass",
                                              num_classes=C, **kw))


@pytest.mark.parametrize("debias", [False, True])
def test_calibration_l2_debias(debias):
    rng = np.random.RandomState(4)
    conf = rng.rand(500).astype(np.float32)
    acc = (rng.rand(500) < conf).astype(np.float32)
    valid = rng.rand(500) < 0.9
    for v in (None, valid):
        want = jax_ce_compute(jnp.asarray(conf), jnp.asarray(acc), 15, "l2", debias=debias,
                              valid=None if v is None else jnp.asarray(v))
        got = _ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), 15, "l2", debias=debias,
                          valid=None if v is None else torch.from_numpy(v))
        assert_close(got, want)


@pytest.mark.parametrize("cat_capacity", [None, 512])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_classes(norm, cat_capacity):
    rng = np.random.RandomState(11 + len(norm))
    extra = {} if cat_capacity is None else {"cat_capacity": cat_capacity}
    pairs = [
        (jc.BinaryCalibrationError(n_bins=15, norm=norm, ignore_index=-1),
         tc.BinaryCalibrationError(n_bins=15, norm=norm, ignore_index=-1, device="cpu", **extra),
         lambda: binary_inputs(rng, logits=False)),
        (jc.MulticlassCalibrationError(C, n_bins=15, norm=norm),
         tc.MulticlassCalibrationError(C, n_bins=15, norm=norm, device="cpu", **extra),
         lambda: multiclass_inputs(rng)),
    ]
    for jax_metric, torch_metric, draw in pairs:
        for step in range(3):
            preds, target = draw()
            if jax_metric.ignore_index is not None:
                target[step::6] = -1
            assert_close(torch_metric(preds, target), jax_metric(jnp.asarray(preds), jnp.asarray(target)))
        assert_close(torch_metric.compute(), jax_metric.compute())
    dispatched = tc.CalibrationError("binary", n_bins=5, device="cpu")
    assert isinstance(dispatched, tc.BinaryCalibrationError) and dispatched.n_bins == 5
    with pytest.raises(ValueError, match="num_classes"):
        tc.CalibrationError("multiclass", device="cpu")


def test_calibration_counts_are_exact_past_2_to_the_24():
    """A deliberate deviation: the JAX package sums the bin counts in float32, which stop
    at 2^24 in a sequential scatter; the port counts in int32. 2^24 + 2 samples in one
    bin, the last two wrong: the port's accuracy is the exact ratio, the JAX package's 1.0."""
    n = (1 << 24) + 2
    conf = np.full(n, 0.5, np.float32)
    acc = np.ones(n, np.float32)
    acc[-2:] = 0
    bounds = _bin_boundaries(15, "cpu")
    acc_bin, _, prop_bin = _binning_bucketize(torch.from_numpy(conf), torch.from_numpy(acc), bounds)
    assert acc_bin[7].item() == np.float32((n - 2) / n)
    assert prop_bin[7].item() == 1.0
    jax_acc = np.asarray(jax_bucketize(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(bounds.numpy()))[0])
    assert jax_acc[7] == 1.0  # float32 counts: 2^24 + 2 rounds to 2^24 along the way


def test_calibration_runs_three_histograms(monkeypatch):
    calls = []
    plain = histogram._plain_bincount
    monkeypatch.setattr(histogram, "_plain_bincount", lambda x, w, b: calls.append((w is None or w.dtype, b))
                        or plain(x, w, b))
    rng = np.random.RandomState(2)
    tf.binary_calibration_error(*binary_inputs(rng), n_bins=15, device="cpu")
    assert calls == [(True, 16), (torch.bool, 16), (torch.float32, 16)]


# ------------------------------------------------------------------------ hinge


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("squared", [False, True])
def test_hinge_functionals(squared, ignore_index):
    rng = np.random.RandomState(20 + squared)
    for logits in (False, True):
        preds, target = binary_inputs(rng, logits=logits)
        mpreds, mtarget = multiclass_inputs(rng, logits=logits)
        if ignore_index is not None:
            target[::4] = ignore_index
            mtarget[::3] = ignore_index
        kw = dict(squared=squared, ignore_index=ignore_index)
        assert_close(tf.binary_hinge_loss(preds, target, device="cpu", **kw),
                     jf.binary_hinge_loss(jnp.asarray(preds), jnp.asarray(target), **kw))
        for mode in ("crammer-singer", "one-vs-all"):
            assert_close(
                tf.multiclass_hinge_loss(mpreds, mtarget, C, multiclass_mode=mode, device="cpu", **kw),
                jf.multiclass_hinge_loss(jnp.asarray(mpreds), jnp.asarray(mtarget), C, multiclass_mode=mode, **kw),
            )
            assert_close(
                tf.hinge_loss(mpreds, mtarget, "multiclass", num_classes=C, multiclass_mode=mode, device="cpu", **kw),
                jf.hinge_loss(jnp.asarray(mpreds), jnp.asarray(mtarget), "multiclass", num_classes=C,
                              multiclass_mode=mode, **kw),
            )


@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
def test_hinge_classes(mode):
    rng = np.random.RandomState(len(mode))
    pairs = [
        (jc.BinaryHingeLoss(squared=True, ignore_index=-1), tc.BinaryHingeLoss(squared=True, ignore_index=-1,
                                                                                device="cpu"),
         lambda: binary_inputs(rng, logits=True)),
        (jc.MulticlassHingeLoss(C, multiclass_mode=mode), tc.MulticlassHingeLoss(C, multiclass_mode=mode,
                                                                                  device="cpu"),
         lambda: multiclass_inputs(rng)),
    ]
    for jax_metric, torch_metric, draw in pairs:
        for step in range(3):
            preds, target = draw()
            if jax_metric.ignore_index is not None:
                target[step::5] = -1
            assert_close(torch_metric(preds, target), jax_metric(jnp.asarray(preds), jnp.asarray(target)))
        assert_close(torch_metric.compute(), jax_metric.compute())
        assert int(torch_metric.total) == int(jax_metric.total)
    assert isinstance(tc.HingeLoss("multiclass", num_classes=C, device="cpu"), tc.MulticlassHingeLoss)


# ---------------------------------------------------------------------- ranking

RANKING = ["multilabel_coverage_error", "multilabel_ranking_average_precision", "multilabel_ranking_loss"]


def multilabel_inputs(rng, n=48, ties=True):
    preds = rng.rand(n, L)
    if ties:  # tie groups within a sample
        preds = np.round(preds, 1)
    target = rng.randint(0, 2, (n, L))
    target[0], target[1] = 0, 1  # a sample with no relevant label, and one with only relevant labels
    return preds.astype(np.float32), target


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", RANKING)
def test_ranking_functionals(name, ties):
    rng = np.random.RandomState(len(name) + ties)
    for ignore_index in (None, -1):
        preds, target = multilabel_inputs(rng, ties=ties)
        if ignore_index is not None:
            target[5::9, 2] = ignore_index
        want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), L, ignore_index=ignore_index)
        got = getattr(tf, name)(preds, target, L, ignore_index=ignore_index, device="cpu")
        assert_close(got, want, RANKING_ATOL)


def test_ranking_pairwise_chunks(monkeypatch):
    """The pairwise compare in chunks of rows gives the values of one pass."""
    from metrics_tpu_torch.functional.classification import ranking

    rng = np.random.RandomState(9)
    preds, target = multilabel_inputs(rng, n=200)
    whole = tf.multilabel_ranking_average_precision(preds, target, L, device="cpu")
    monkeypatch.setattr(ranking, "_PAIRWISE_ROWS", 7)
    chunked = tf.multilabel_ranking_average_precision(preds, target, L, device="cpu")
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("name", ["MultilabelCoverageError", "MultilabelRankingAveragePrecision",
                                  "MultilabelRankingLoss"])
def test_ranking_classes(name):
    rng = np.random.RandomState(len(name))
    jax_metric, torch_metric = getattr(jc, name)(L), getattr(tc, name)(L, device="cpu")
    for _ in range(3):
        preds, target = multilabel_inputs(rng)
        assert_close(torch_metric(preds, target), jax_metric(jnp.asarray(preds), jnp.asarray(target)), RANKING_ATOL)
    assert_close(torch_metric.compute(), jax_metric.compute(), RANKING_ATOL)
    assert int(torch_metric.total) == int(jax_metric.total)


# --------------------------------------------------------------------- fairness


def fairness_inputs(rng, n=80, ignore_index=None):
    preds, target = rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    groups = rng.randint(0, G, n)
    if ignore_index is not None:
        target[::6] = ignore_index
    return preds, target, groups


def assert_dict_close(got, want):
    assert list(got) == list(want)
    for key in want:
        assert_close(got[key], want[key])


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_fairness_functionals(ignore_index):
    rng = np.random.RandomState(31)
    preds, target, groups = fairness_inputs(rng, ignore_index=ignore_index)
    j = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
    kw = dict(ignore_index=ignore_index)
    assert_dict_close(tf.binary_groups_stat_rates(preds, target, groups, G, device="cpu", **kw),
                      jf.binary_groups_stat_rates(*j, G, **kw))
    assert_dict_close(tf.demographic_parity(preds, groups, device="cpu", **kw),
                      jf.demographic_parity(j[0], j[2], **kw))
    assert_dict_close(tf.equal_opportunity(preds, target, groups, device="cpu", **kw),
                      jf.equal_opportunity(*j, **kw))
    for task in ("all", "equal_opportunity"):
        assert_dict_close(tf.binary_fairness(preds, target, groups, task, device="cpu", **kw),
                          jf.binary_fairness(*j, task, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_dict_close(tf.binary_fairness(preds, target, groups, "demographic_parity", device="cpu", **kw),
                          jf.binary_fairness(*j, "demographic_parity", **kw))


def test_fairness_group_ids_out_of_range():
    rng = np.random.RandomState(32)
    preds, target, groups = fairness_inputs(rng)
    for bad in (G, -1):
        groups_bad = groups.copy()
        groups_bad[3] = bad
        for fn in (tf.binary_groups_stat_rates, jf.binary_groups_stat_rates):
            with pytest.raises(ValueError, match="groups tensor"):
                fn(preds if fn is tf.binary_groups_stat_rates else jnp.asarray(preds), target, groups_bad, G,
                   **({"device": "cpu"} if fn is tf.binary_groups_stat_rates else {}))
        # without validation the sample drops, as in the JAX package
        jax_metric = jc.BinaryGroupStatRates(G, validate_args=False)
        torch_metric = tc.BinaryGroupStatRates(G, validate_args=False, device="cpu")
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups_bad))
        torch_metric.update(preds, target, groups_bad)
        for s in ("tp", "fp", "tn", "fn"):
            np.testing.assert_array_equal(getattr(torch_metric, s).numpy(), np.asarray(getattr(jax_metric, s)))
        assert int(sum(getattr(torch_metric, s).sum() for s in ("tp", "fp", "tn", "fn"))) == preds.size - 1


@pytest.mark.parametrize("task", ["all", "demographic_parity", "equal_opportunity"])
def test_fairness_classes(task):
    rng = np.random.RandomState(len(task))
    jax_metric = jc.BinaryFairness(G, task=task, ignore_index=-1)
    torch_metric = tc.BinaryFairness(G, task=task, ignore_index=-1, device="cpu")
    rates_jax, rates_torch = jc.BinaryGroupStatRates(G), tc.BinaryGroupStatRates(G, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # demographic parity warns that it takes no target
        for _ in range(3):
            preds, target, groups = fairness_inputs(rng, ignore_index=-1)
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
            torch_metric.update(preds, target, groups)
            target[target < 0] = 0
            rates_jax.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
            rates_torch.update(preds, target, groups)
    for s in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(torch_metric, s).numpy(), np.asarray(getattr(jax_metric, s)))
    assert_dict_close(torch_metric.compute(), jax_metric.compute())
    assert_dict_close(rates_torch.compute(), rates_jax.compute())


# ------------------------------------------------------------------------- dice

DICE_CASES = [
    dict(average="micro"),
    dict(average="macro", num_classes=C),
    dict(average="weighted", num_classes=C),
    dict(average="none", num_classes=C),
    dict(average="samples"),
    dict(average="micro", num_classes=C, ignore_index=0),
    dict(average="macro", num_classes=C, ignore_index=2),
    dict(average="micro", top_k=2),
]


@pytest.mark.parametrize("kwargs", DICE_CASES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_dice_functional(kwargs):
    rng = np.random.RandomState(40)
    for preds, target in (
        (rng.randint(0, C, 50), rng.randint(0, C, 50)),  # labels
        (rng.rand(50, C).astype(np.float32), rng.randint(0, C, 50)),  # probabilities
        (rng.rand(6, C, 4, 5).astype(np.float32), rng.randint(0, C, (6, 4, 5))),  # multidim multiclass
    ):
        if kwargs.get("top_k") and preds.dtype != np.float32:
            continue
        want = jf.dice(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        got = tf.dice(preds, target, device="cpu", **kwargs)
        assert_close(got, want)
    for preds, target in ((rng.rand(50).astype(np.float32), rng.randint(0, 2, 50)),):  # binary
        if "num_classes" in kwargs or kwargs.get("top_k") or kwargs["average"] == "samples":
            continue
        assert_close(tf.dice(preds, target, device="cpu", **kwargs), jf.dice(jnp.asarray(preds),
                                                                              jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "samples"])
def test_dice_class(average, mdmc_average):
    rng = np.random.RandomState(41)
    kwargs = dict(average=average, mdmc_average=mdmc_average, num_classes=C)
    jax_metric, torch_metric = jc.Dice(**kwargs), tc.Dice(device="cpu", **kwargs)
    for _ in range(3):
        preds, target = rng.rand(4, C, 3, 5).astype(np.float32), rng.randint(0, C, (4, 3, 5))
        assert_close(torch_metric(preds, target), jax_metric(jnp.asarray(preds), jnp.asarray(target)))
    assert_close(torch_metric.compute(), jax_metric.compute())
    for s in ("tp", "fp", "tn", "fn"):
        want = getattr(jax_metric, s)
        want = np.concatenate([np.atleast_1d(np.asarray(v)) for v in want]) if isinstance(want, list) else want
        got = getattr(torch_metric, s)
        got = torch.cat([torch.atleast_1d(v) for v in got]) if isinstance(got, list) else got
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dice_segmentation_equals_twice_tp_over_confusion():
    """(N, C, H, W) logits with a void label mapped to an ignored extra class: micro Dice
    from the legacy one-hot path equals 2 tp / (2 tp + fp + fn) read off the confusion
    matrix of the same batch (the ignored class's column deleted)."""
    rng = np.random.RandomState(42)
    logits = rng.randn(2, C + 1, 6, 7).astype(np.float32)
    logits[:, C] = -1e9  # the void class is never predicted
    target = rng.randint(0, C + 1, (2, 6, 7))
    metric = tc.Dice(num_classes=C + 1, ignore_index=C, device="cpu")
    metric.update(logits, target)
    pred = logits.argmax(1).reshape(-1)
    cm = np.zeros((C + 1, C + 1), np.int64)
    np.add.at(cm, (target.reshape(-1), pred), 1)
    keep = np.arange(C)
    tp = np.trace(cm[:C, :C])
    fp = cm[:, keep].sum() - tp
    fn = cm[keep, :].sum() - tp
    want = np.float32(np.float32(2 * tp) / np.float32(2 * tp + fp + fn))
    assert metric.compute().item() == want
    assert_close(metric.compute(), jc.Dice(num_classes=C + 1, ignore_index=C)(jnp.asarray(logits),
                                                                              jnp.asarray(target)))


# ---------------------------------------------------------- exports, states


def test_classification_names_match_the_jax_package():
    assert set(jc.__all__) <= set(tc.__all__)
    for name in jc.__all__:
        assert hasattr(tc, name), name
    public = [n for n in dir(jf) if not n.startswith("_") and inspect.isfunction(getattr(jf, n))]
    assert len(public) >= 93
    missing = [n for n in public if not hasattr(tf, n)]
    assert not missing, missing


def test_root_exports():
    """The root exports what metrics_tpu's root exports of the ported families."""
    ported = set(tc.__all__) | set(metrics_tpu_torch.retrieval.__all__) | set(metrics_tpu_torch.core.__all__)
    want = {n for n in metrics_tpu.__all__ if n in ported or n == "functional"}
    assert want <= set(metrics_tpu_torch.__all__)
    for name in ("MetricCollection", "CompositionalMetric", "MeanMetric", "SumMetric", "MaxMetric", "MinMetric",
                 "CatMetric", "MulticlassAccuracy", "Dice", "CalibrationError", "functional"):
        assert hasattr(metrics_tpu_torch, name), name
    from metrics_tpu_torch import MetricCollection, MulticlassAccuracy  # noqa: F401

    assert metrics_tpu_torch.functional.dice is tf.dice


def test_root_retrieval_shims_warn_and_subpackage_is_silent():
    with pytest.warns(FutureWarning, match="Import `RetrievalMAP` from `metrics_tpu_torch.retrieval`"):
        metric = metrics_tpu_torch.RetrievalMAP(device="cpu")
    assert isinstance(metric, metrics_tpu_torch.retrieval.RetrievalMAP)
    with pytest.warns(FutureWarning, match="functional.retrieval"):
        metrics_tpu_torch.functional.retrieval_precision(torch.tensor([0.2, 0.7]), torch.tensor([0, 1]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        metrics_tpu_torch.retrieval.RetrievalMAP(device="cpu")
        metrics_tpu_torch.functional.retrieval.retrieval_precision(torch.tensor([0.2, 0.7]), torch.tensor([0, 1]))


def _jax_state(metric):
    metric.persistent(True)
    return metric.state_dict()


def test_load_jax_state_of_the_new_classes():
    rng = np.random.RandomState(50)
    preds, target = binary_inputs(rng)
    mpreds, mtarget = multiclass_inputs(rng)
    lpreds, ltarget = multilabel_inputs(rng)
    fpreds, ftarget, groups = fairness_inputs(rng)
    cases = [
        ("BinaryCalibrationError", {}, (preds, target)),
        ("MulticlassCalibrationError", {"num_classes": C}, (mpreds, mtarget)),
        ("BinaryHingeLoss", {}, (preds, target)),
        ("MulticlassHingeLoss", {"num_classes": C, "multiclass_mode": "one-vs-all"}, (mpreds, mtarget)),
        ("MultilabelRankingLoss", {"num_labels": L}, (lpreds, ltarget)),
        ("MultilabelCoverageError", {"num_labels": L}, (lpreds, ltarget)),
        ("BinaryFairness", {"num_groups": G}, (fpreds, ftarget, groups)),
        ("Dice", {"average": "macro", "num_classes": C}, (mpreds, mtarget)),
        ("Dice", {"average": "samples"}, (mpreds, mtarget)),
        ("MulticlassRecallAtFixedPrecision", {"num_classes": C, "min_precision": 0.5}, (mpreds, mtarget)),
    ]
    for name, kwargs, args in cases:
        jax_metric = getattr(jc, name)(**kwargs)
        for _ in range(2):
            jax_metric.update(*(jnp.asarray(a) for a in args))
        port = load_jax_state(getattr(tc, name)(device="cpu", **kwargs), _jax_state(jax_metric))
        got, want = port.compute(), jax_metric.compute()
        if isinstance(want, dict):
            assert_dict_close(got, want)
        elif isinstance(want, tuple):
            for g, w in zip(got, want):
                assert_close(g, w)
        else:
            assert_close(got, want, RANKING_ATOL)


def test_load_jax_state_of_calibration_buffers():
    rng = np.random.RandomState(51)
    jax_metric = jc.BinaryCalibrationError(cat_capacity=256)
    for _ in range(2):
        jax_metric.update(*(jnp.asarray(a) for a in binary_inputs(rng)))
    port = load_jax_state(tc.BinaryCalibrationError(cat_capacity=256, device="cpu"), _jax_state(jax_metric))
    assert type(port.confidences).__name__ == "CatBuffer" and port.accuracies.data.dtype == torch.int32
    assert_close(port.compute(), jax_metric.compute())
