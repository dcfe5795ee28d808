"""The nominal slice of metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy inputs, drawn from seeded generators, go through the JAX package and
the port (``device="cpu"``): the four single-pair functionals and their ``_matrix``
forms under both ``nan_strategy`` values, with bias correction on and off, within
1e-6 (the tolerance of ``tests/unittests/nominal/test_nominal_pairwise.py``); the
labels as ±0.0, non-contiguous and 1-based values, 2-D inputs (argmaxed), a constant
column (the bias-correction NaN and its warning), Theil's U both ways round.

Exact parts: ``pair_confusion_counts`` gives each pair's table equal, bit for bit, to
the JAX package's per-pair confusion matrix once both drop their empty rows and
columns, in one histogram call for the UCI Adult cardinalities (3,982 bins) and in
windows of at most 2^14 bins past that; the classes' int64 tables equal the JAX
float32 ones; ``load_jax_state`` carries a JAX class's table across.
"""
import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jfr
import metrics_tpu.functional.nominal as jf
import metrics_tpu.nominal as jn
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.nominal as tf
import metrics_tpu_torch.nominal as tn
from metrics_tpu.functional.classification.confusion_matrix import (
    _multiclass_confusion_matrix_update as jax_confmat_update,
)
from metrics_tpu.functional.nominal.utils import _format_and_densify as jax_format_and_densify
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.functional.nominal.utils import _densify_columns
from metrics_tpu_torch.ops import confmat as ops_confmat
from metrics_tpu_torch.ops.confmat import pair_confusion_counts
from tests.torch_deadline import deadline  # noqa: F401

ATOL = 1e-6
# UCI Adult's categorical columns with "?" counted as a category: workclass, education,
# marital-status, occupation, relationship, race, sex, native-country
ADULT_CARDINALITIES = (9, 16, 7, 15, 6, 5, 2, 42)
BIASED = ("cramers_v", "tschuprows_t")
SINGLE = ("cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u")
# (functional, bias_correction): the two metrics without the argument once each
WITH_BIAS = [(n, b) for n in BIASED for b in (True, False)] + [(n, False) for n in SINGLE[2:]]


def kwargs_of(name: str, bias_correction: bool, nan_strategy: str) -> dict:
    kwargs = {"nan_strategy": nan_strategy}
    if name.startswith(BIASED):
        kwargs["bias_correction"] = bias_correction
    return kwargs


def assert_close(got, want, atol: float = ATOL) -> None:
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)  # NaN only where the JAX package has NaN


def series(seed: int, n: int = 120, classes: int = 5, nan_rate: float = 0.0):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, classes, n).astype(np.float32)
    target = np.where(rng.random(n) < 0.6, preds, rng.integers(0, classes, n)).astype(np.float32)
    if nan_rate:
        preds[rng.random(n) < nan_rate] = np.nan
        target[rng.random(n) < nan_rate] = np.nan
    return preds, target


def adult_like(seed: int, n: int = 400, nan_rate: float = 0.05):
    """Columns at the Adult cardinalities, two dependent pairs, NaN in three columns."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, c, n) for c in ADULT_CARDINALITIES]
    cols[3] = np.where(rng.random(n) < 0.7, cols[1] % 15, cols[3])  # education -> occupation
    cols[6] = np.where(rng.random(n) < 0.8, cols[4] % 2, cols[6])  # relationship -> sex
    m = np.stack(cols, 1).astype(np.float32)
    for c in (0, 3, 7):
        m[rng.random(n) < nan_rate, c] = np.nan
    return m


def label_cases():
    """Single-pair inputs whose labels the densification must handle."""
    p, t = series(1)
    rng = np.random.default_rng(7)
    signed = np.where(rng.random(len(p)) < 0.5, -0.0, 0.0).astype(np.float32)
    return {
        "plain": (p, t),
        "signed_zero": (np.where(p == 0, signed, p), np.where(t == 0, signed, t)),
        "non_contiguous": (np.asarray([3, 7, 100, 2000])[p.astype(int) % 4], np.asarray([7, 100, 3, 42])[t.astype(int) % 4]),
        "one_based": (p + 1, t + 1),
        "mixed_dtypes": (p.astype(np.int64), t),
        "two_d": (rng.standard_normal((len(p), 4)).astype(np.float32), t),
        "nan": series(2, nan_rate=0.1),
    }


# --------------------------------------------------------------- functionals


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("case", list(label_cases()))
@pytest.mark.parametrize("name,bias_correction", WITH_BIAS)
def test_single_pair_functionals_match_jax(name, bias_correction, case, nan_strategy):
    preds, target = label_cases()[case]
    kwargs = kwargs_of(name, bias_correction, nan_strategy)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, name)(preds, target, device="cpu", **kwargs)
    assert got.dtype == torch.float32 and got.shape == ()
    assert_close(got, want)


def test_theils_u_is_asymmetric_in_both_packages():
    preds, target = series(3, classes=6)
    target = target % 3  # a coarser target: U(p|t) != U(t|p)
    forward = tf.theils_u(preds, target, device="cpu")
    backward = tf.theils_u(target, preds, device="cpu")
    assert abs(float(forward) - float(backward)) > 1e-3
    assert_close(forward, jf.theils_u(jnp.asarray(preds), jnp.asarray(target)))
    assert_close(backward, jf.theils_u(jnp.asarray(target), jnp.asarray(preds)))


@pytest.mark.parametrize("name", BIASED)
def test_bias_correction_nan_and_warning_on_a_constant_series(name):
    preds, _ = series(4)
    target = np.full_like(preds, 2.0)
    with pytest.warns(UserWarning, match="Unable to compute"):
        want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target))
    with pytest.warns(UserWarning, match="Unable to compute"):
        got = getattr(tf, name)(preds, target, device="cpu")
    assert np.isnan(float(want)) and torch.isnan(got)
    # without bias correction both give NaN (0/0) and stay silent
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = getattr(tf, name)(preds, target, bias_correction=False, device="cpu")
    assert_close(got, getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), bias_correction=False))


def test_functional_errors_match_jax():
    p, t = series(5)
    for bad in ({"nan_strategy": "fill"}, {"nan_strategy": "replace", "nan_replace_value": "x"}):
        with pytest.raises(ValueError) as want:
            jf.cramers_v(jnp.asarray(p), jnp.asarray(t), **bad)
        with pytest.raises(ValueError) as got:
            tf.cramers_v(p, t, device="cpu", **bad)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- matrix forms


def matrix_case(seed: int) -> np.ndarray:
    """Adult-like columns plus a constant one, a ±0.0 one and a 1-based one."""
    m = adult_like(seed, n=200)[:, [1, 3, 4]]
    rng = np.random.default_rng(seed + 100)
    signed = np.where(rng.random(len(m)) < 0.5, -0.0, 0.0)
    extra = np.stack([np.full(len(m), 3.0), np.where(m[:, 2] == 0, signed, m[:, 2]), m[:, 0] + 1], 1)
    return np.concatenate([m, extra.astype(np.float32)], 1)


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("name,bias_correction", WITH_BIAS)
def test_matrix_forms_match_jax(name, bias_correction, nan_strategy):
    m = matrix_case(11)
    kwargs = kwargs_of(name, bias_correction, nan_strategy)
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        want = np.asarray(getattr(jf, f"{name}_matrix")(jnp.asarray(m), **kwargs))
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got = getattr(tf, f"{name}_matrix")(m, device="cpu", **kwargs)
    assert got.dtype == torch.float32 and got.shape == (m.shape[1], m.shape[1])
    assert_close(got, want)
    # one warning per pair whose bias correction fails, in both packages
    count = lambda ws: sum("Unable to compute" in str(w.message) for w in ws)  # noqa: E731
    assert count(port_warned) == count(jax_warned)
    if name.startswith(BIASED) and bias_correction:
        assert count(port_warned) == m.shape[1] - 1  # the constant column against every other


def test_theils_u_matrix_is_asymmetric_and_matches_jax():
    m = adult_like(12, n=300)[:, [0, 1, 3, 6]]
    got = tf.theils_u_matrix(m, nan_strategy="drop", device="cpu")
    assert not torch.allclose(got, got.T)
    assert_close(got, jf.theils_u_matrix(jnp.asarray(m), nan_strategy="drop"))


@pytest.mark.parametrize("name", SINGLE)
def test_matrix_of_integer_columns_and_of_one_column(name):
    m = np.random.default_rng(13).integers(-2, 4, (80, 3))
    assert_close(getattr(tf, f"{name}_matrix")(m, device="cpu"), getattr(jf, f"{name}_matrix")(jnp.asarray(m)))
    one = getattr(tf, f"{name}_matrix")(m[:, :1], device="cpu")
    assert torch.equal(one, torch.ones((1, 1)))


# -------------------------------------------------- the batched pair count


def jax_pair_table(x: np.ndarray, y: np.ndarray, nan_strategy: str) -> np.ndarray:
    """The JAX package's per-pair confusion matrix, its empty rows and columns dropped."""
    xd, yd, c = jax_format_and_densify(jnp.asarray(x), jnp.asarray(y), nan_strategy, 0.0)
    cm = np.asarray(jax_confmat_update(xd, yd, c))
    cm = cm[cm.sum(1) != 0]
    return cm[:, cm.sum(0) != 0]


def dropped(table: torch.Tensor) -> np.ndarray:
    t = table.numpy()
    t = t[t.sum(1) != 0]
    return t[:, t.sum(0) != 0]


class CountingBincount:
    """Stands in for ``ops.confmat._bincount``: counts calls and their bins."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, ids, bins):
        self.calls.append(bins)
        return self.real(ids, bins)


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_pair_counts_equal_jax_per_pair_matrices_in_one_call(monkeypatch, nan_strategy):
    m = adult_like(21)
    counting = CountingBincount(ops_confmat._bincount)
    monkeypatch.setattr(ops_confmat, "_bincount", counting)
    ids, valid, cards = _densify_columns(torch.tensor(m), nan_strategy, 0.0)
    pairs = list(itertools.combinations(range(m.shape[1]), 2))
    tables = pair_confusion_counts(ids, pairs, cards, valid)
    assert cards == list(ADULT_CARDINALITIES)
    assert counting.calls == [sum(cards[i] * cards[j] for i, j in pairs)] == [3982]
    assert tables.dtype == torch.int64 and tables.shape == (28, 42, 16)
    for p, (i, j) in enumerate(pairs):
        want = jax_pair_table(m[:, i], m[:, j], nan_strategy)
        got = dropped(tables[p])
        assert got.shape == want.shape and np.array_equal(got, want.astype(np.int64)), (i, j)


def test_pair_counts_past_2_14_bins_go_in_windows(monkeypatch):
    rng = np.random.default_rng(22)
    cards = (200, 150, 3, 90)  # 30,000 + 600 + 18,000 + 450 + 13,500 + 270 bins
    m = np.stack([rng.integers(0, c, 5000) for c in cards], 1)
    m[:, 1] = np.where(rng.random(5000) < 0.5, m[:, 0] % 150, m[:, 1])
    counting = CountingBincount(ops_confmat._bincount)
    monkeypatch.setattr(ops_confmat, "_bincount", counting)
    ids, valid, got_cards = _densify_columns(torch.tensor(m), "replace", 0.0)
    pairs = list(itertools.combinations(range(4), 2))
    tables = pair_confusion_counts(ids, pairs, got_cards, valid)
    total = sum(got_cards[i] * got_cards[j] for i, j in pairs)
    # windows 16384 + 13616 | 600 | 16384 + 1616 | 450 | 13500 | 270, packed greedily
    assert counting.calls == [16384, 13616 + 600, 16384, 1616 + 450 + 13500 + 270] and sum(counting.calls) == total
    for p, (i, j) in enumerate(pairs):
        assert np.array_equal(dropped(tables[p]), jax_pair_table(m[:, i], m[:, j], "replace").astype(np.int64))


@pytest.mark.parametrize("max_bins", [1, 7, 64, 1000])
def test_pair_counts_are_the_same_at_any_window_size(monkeypatch, max_bins):
    m = adult_like(23, n=150)
    ids, valid, cards = _densify_columns(torch.tensor(m), "drop", 0.0)
    pairs = list(itertools.combinations(range(m.shape[1]), 2))
    whole = pair_confusion_counts(ids, pairs, cards, valid)
    counting = CountingBincount(ops_confmat._bincount)
    monkeypatch.setattr(ops_confmat, "_bincount", counting)
    monkeypatch.setattr(ops_confmat, "KERNEL_MAX_BINS", max_bins)
    assert torch.equal(pair_confusion_counts(ids, pairs, cards, valid), whole)
    assert max(counting.calls) <= max_bins


def test_densify_columns_keeps_label_order_signed_zero_and_nan():
    m = torch.tensor([[3.0, -0.0], [float("nan"), 0.0], [-1.0, 2.0], [3.0, float("nan")], [10.0, -0.0]])
    ids, valid, cards = _densify_columns(m, "drop", 0.0)
    assert cards == [3, 2]
    assert ids[valid[:, 0], 0].tolist() == [1, 0, 1, 2]
    assert ids[valid[:, 1], 1].tolist() == [0, 0, 1, 0]
    ids, valid, cards = _densify_columns(m, "replace", 5.0)
    assert valid is None and cards == [4, 3] and ids[1, 0].item() == 2 and ids[3, 1].item() == 2


# ------------------------------------------------------------------ classes


CLASSES = {
    "CramersV": {"bias_correction": True},
    "TschuprowsT": {"bias_correction": False},
    "PearsonsContingencyCoefficient": {},
    "TheilsU": {},
}


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_classes_over_three_updates_and_forward_match_jax(name, nan_strategy):
    kwargs = {"num_classes": 5, "nan_strategy": nan_strategy, **CLASSES[name]}
    jax_metric, port = getattr(jn, name)(**kwargs), getattr(tn, name)(device="cpu", **kwargs)
    batches = [series(30 + k, n=50, nan_rate=0.05) for k in range(4)]
    for p, t in batches[:3]:
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.tensor(p), torch.tensor(t))
    assert port.confmat.dtype == torch.int64
    assert np.array_equal(port.confmat.numpy(), np.asarray(jax_metric.confmat).astype(np.int64))
    assert_close(port.compute(), jax_metric.compute())
    p, t = batches[3]
    assert_close(port(torch.tensor(p), torch.tensor(t)), jax_metric(jnp.asarray(p), jnp.asarray(t)))
    assert np.array_equal(port.confmat.numpy(), np.asarray(jax_metric.confmat).astype(np.int64))
    assert_close(port.compute(), jax_metric.compute())
    port.reset()
    assert int(port.confmat.sum()) == 0


def test_classes_take_2d_inputs_and_refuse_labels_out_of_range():
    rng = np.random.default_rng(40)
    logits, target = rng.standard_normal((60, 4)).astype(np.float32), rng.integers(0, 4, 60)
    jax_metric, port = jn.TheilsU(num_classes=4), tn.TheilsU(num_classes=4, device="cpu")
    jax_metric.update(jnp.asarray(logits), jnp.asarray(target))
    port.update(torch.tensor(logits), torch.tensor(target))
    assert_close(port.compute(), jax_metric.compute())
    for bad in (target + 1, target - 1):
        with pytest.raises(ValueError) as want:
            jn.CramersV(num_classes=4).update(jnp.asarray(target), jnp.asarray(bad))
        with pytest.raises(ValueError) as got:
            tn.CramersV(num_classes=4, device="cpu").update(torch.tensor(target), torch.tensor(bad))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="positive integer"):
        tn.CramersV(num_classes=0, device="cpu")


@pytest.mark.parametrize("name", list(CLASSES))
def test_load_jax_state_of_a_class_table(name):
    kwargs = {"num_classes": 5, **CLASSES[name]}
    jax_metric = getattr(jn, name)(**kwargs)
    for k in range(2):
        p, t = series(50 + k, n=60)
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
    jax_metric.persistent(True)
    state = jax_metric.state_dict()
    assert np.asarray(state["confmat"]).dtype == np.float32
    port = load_jax_state(getattr(tn, name)(device="cpu", **kwargs), state)
    assert port.confmat.dtype == torch.int64
    assert np.array_equal(port.confmat.numpy(), np.asarray(state["confmat"]).astype(np.int64))
    assert_close(port.compute(), jax_metric.compute())
    state["confmat"] = np.asarray(state["confmat"]) + 0.5
    with pytest.raises(ValueError, match="non-integral"):
        load_jax_state(getattr(tn, name)(device="cpu", **kwargs), state)


def test_exports_match_jax():
    for name in ("CramersV", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"):
        assert getattr(metrics_tpu_torch, name) is getattr(tn, name)
        assert hasattr(metrics_tpu, name)
    assert set(tn.__all__) == set(jn.__all__)
    assert set(tf.__all__) == set(jf.__all__)
    for name in tf.__all__:
        assert getattr(tfr, name) is getattr(tf, name) and hasattr(jfr, name)
