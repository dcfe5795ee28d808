"""The regression slice of metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy inputs, drawn from seeded ``np.random.RandomState``s, go through the
JAX package and the port (``device="cpu"``): every functional over its arguments, every
class over three batches (and ``forward``), the states carried across with
``load_jax_state`` (Pearson's moments stacked, the ``cat`` lists), the exports and
their names, and the errors by type and message. Tolerances are those of the JAX
package's own tests (``tests/unittests/regression/test_regression.py``): 1e-5
relative for the error family, 1e-4 for LogCosh, Minkowski, KL, R2, explained
variance and the correlations.

Exact parts: Spearman's tie-averaged ranks equal ``_rank_data``'s on tied, ±0.0 and
NaN inputs; Kendall's four pair counts equal the JAX package's int32 sums over its
sign matrices, inf and NaN included; the plain count is int64 and its chunk sums pass
2^31 exactly. The deliberate deviations are held too: denormals (XLA's CPU flushes
them to zero, the port keeps them), int64 counts.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jfr
import metrics_tpu.functional.regression as jf
import metrics_tpu.regression as jr
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.regression as tf
import metrics_tpu_torch.regression as tr
from metrics_tpu.functional.regression.spearman import _rank_data
from metrics_tpu.regression.pearson import _final_aggregation as jax_final_aggregation
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.ops import kendall as tk
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.ops.rank import average_ranks
from metrics_tpu_torch.regression.pearson import _final_aggregation
from metrics_tpu_torch.utils.exceptions import MetricsUserError

N = 40
C = 3


def data(seed: int, shape=(N,), positive: bool = False):
    rng = np.random.RandomState(seed)
    preds = rng.randn(*shape).astype(np.float32)
    target = (preds + 0.5 * rng.randn(*shape)).astype(np.float32)
    if positive:
        preds, target = np.abs(preds) + 0.1, np.abs(target) + 0.1
    return preds, target


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_close(got, want, rtol: float, atol: float = 1e-6):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rtol, atol)
        return
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------------------- functionals

# name, kwargs, input shape, positive inputs, rtol
FUNCTIONAL_CASES = [
    ("mean_squared_error", {}, (N,), False, 1e-5),
    ("mean_squared_error", {"squared": False}, (N, C), False, 1e-5),
    ("mean_absolute_error", {}, (N,), False, 1e-5),
    ("mean_absolute_percentage_error", {}, (N,), True, 1e-5),
    ("symmetric_mean_absolute_percentage_error", {}, (N,), False, 1e-5),
    ("weighted_mean_absolute_percentage_error", {}, (N,), False, 1e-5),
    ("mean_squared_log_error", {}, (N,), True, 1e-5),
    ("log_cosh_error", {}, (N,), False, 1e-4),
    ("log_cosh_error", {}, (N, C), False, 1e-4),
    ("minkowski_distance", {"p": 3}, (N,), False, 1e-4),
    ("minkowski_distance", {"p": 1.5}, (N, C), False, 1e-4),
    ("cosine_similarity", {}, (N, C), False, 1e-5),
    ("cosine_similarity", {"reduction": "mean"}, (N, C), False, 1e-5),
    ("cosine_similarity", {"reduction": "none"}, (N, C), False, 1e-5),
    ("kl_divergence", {}, (N, C), True, 1e-4),
    ("kl_divergence", {"reduction": "sum"}, (N, C), True, 1e-4),
    ("kl_divergence", {"reduction": "none", "log_prob": True}, (N, C), False, 1e-4),
    ("explained_variance", {}, (N, C), False, 1e-4),
    ("explained_variance", {"multioutput": "raw_values"}, (N, C), False, 1e-4),
    ("explained_variance", {"multioutput": "variance_weighted"}, (N, C), False, 1e-4),
    ("r2_score", {}, (N,), False, 1e-4),
    ("r2_score", {"multioutput": "raw_values"}, (N, C), False, 1e-4),
    ("r2_score", {"multioutput": "variance_weighted", "adjusted": 3}, (N, C), False, 1e-4),
    ("tweedie_deviance_score", {"power": 0.0}, (N,), False, 1e-5),
    ("tweedie_deviance_score", {"power": 1.0}, (N,), True, 1e-5),
    ("tweedie_deviance_score", {"power": 1.5}, (N,), True, 1e-5),
    ("tweedie_deviance_score", {"power": 2.0}, (N,), True, 1e-5),
    ("tweedie_deviance_score", {"power": 3.0}, (N,), True, 1e-5),
    ("tweedie_deviance_score", {"power": -1.0}, (N,), True, 1e-5),
    ("pearson_corrcoef", {}, (N,), False, 1e-4),
    ("pearson_corrcoef", {}, (N, C), False, 1e-4),
    ("concordance_corrcoef", {}, (N,), False, 1e-4),
    ("concordance_corrcoef", {}, (N, C), False, 1e-4),
    ("spearman_corrcoef", {}, (N,), False, 1e-4),
    ("spearman_corrcoef", {}, (N, C), False, 1e-4),
    ("kendall_rank_corrcoef", {}, (N,), False, 1e-4),
    ("kendall_rank_corrcoef", {"variant": "a"}, (N, C), False, 1e-4),
    ("kendall_rank_corrcoef", {"variant": "c"}, (N, C), False, 1e-4),
    ("kendall_rank_corrcoef", {"t_test": True}, (N,), False, 1e-4),
    ("kendall_rank_corrcoef", {"variant": "c", "t_test": True, "alternative": "greater"}, (N, C), False, 1e-4),
    ("kendall_rank_corrcoef", {"variant": "a", "t_test": True, "alternative": "less"}, (N, C), False, 1e-4),
]


@pytest.mark.parametrize("name,kwargs,shape,positive,rtol", FUNCTIONAL_CASES, ids=lambda v: str(v))
def test_functional_matches_jax(name, kwargs, shape, positive, rtol):
    preds, target = data(len(name) + len(kwargs), shape, positive)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, name)(preds, target, **kwargs, device="cpu")
    assert_close(got, want, rtol)


def test_tied_correlations_match_jax():
    """Spearman and Kendall (a, b, c with its p-value) on inputs with many ties."""
    rng = np.random.RandomState(3)
    preds = rng.randint(0, 6, (N, C)).astype(np.float32)
    target = (preds + rng.randint(-2, 3, (N, C))).astype(np.float32)
    assert_close(tf.spearman_corrcoef(preds, target, device="cpu"),
                 jf.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target)), 1e-4)
    for variant in "abc":
        want = jf.kendall_rank_corrcoef(jnp.asarray(preds), jnp.asarray(target), variant=variant, t_test=True)
        got = tf.kendall_rank_corrcoef(preds, target, variant=variant, t_test=True, device="cpu")
        assert_close(got, want, 1e-4, atol=1e-7)


# ------------------------------------------------------------ Spearman's ranks


def _rank_cases():
    rng = np.random.RandomState(7)
    tied = rng.randint(0, 5, 33).astype(np.float32)
    zeros = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, 0.0, 2.0, -0.0], np.float32)
    nans = np.array([1.0, np.nan, 0.5, np.nan, 1.0, -np.nan, np.inf, -np.inf, 0.0, np.nan], np.float32)
    mixed = np.concatenate([tied[:10], zeros, nans, rng.randn(7).astype(np.float32)])
    return {"tied": tied, "signed_zeros": zeros, "nan_inf": nans, "mixed": mixed}


@pytest.mark.parametrize("case", sorted(_rank_cases()))
def test_average_ranks_bit_equal_to_rank_data(case):
    x = _rank_cases()[case]
    want = np.asarray(_rank_data(jnp.asarray(x)), np.float64)
    got = average_ranks(torch.from_numpy(x)[:, None])[:, 0].numpy()
    np.testing.assert_array_equal(got, want)


def test_average_ranks_of_many_columns_in_one_pass():
    """Every column ranks as it would alone; the scans see C columns as segments."""
    cases = _rank_cases()
    x = np.stack([cases["tied"], cases["tied"][::-1], -cases["tied"]], axis=1)
    got = average_ranks(torch.from_numpy(x))
    for j in range(x.shape[1]):
        np.testing.assert_array_equal(got[:, j].numpy(), np.asarray(_rank_data(jnp.asarray(x[:, j])), np.float64))


def test_spearman_compute_runs_two_scans_whatever_the_columns(monkeypatch):
    calls = []
    real = segment.segment_multi_scan

    def counting(*args, **kwargs):
        calls.append(kwargs.get("ops"))
        return real(*args, **kwargs)

    monkeypatch.setattr(segment, "segment_multi_scan", counting)
    preds, target = data(5, (N, 12))
    tf.spearman_corrcoef(preds, target, device="cpu")
    assert calls == [("min",), ("max",)]


def test_denormals_keep_their_own_rank_where_xla_flushes_them():
    """A deliberate deviation: XLA's CPU flushes denormals, so the JAX package ties
    them with 0.0; the port (and the card, built without fast math) keeps IEEE order."""
    x = np.array([0.0, 1e-40, -1e-40, 1.0], np.float32)
    np.testing.assert_array_equal(np.asarray(_rank_data(jnp.asarray(x))), [2.0, 2.0, 2.0, 4.0])
    np.testing.assert_array_equal(average_ranks(torch.from_numpy(x)[:, None])[:, 0].numpy(), [2.0, 3.0, 1.0, 4.0])


# ----------------------------------------------------------- Kendall's counts


def jax_pair_counts(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The JAX package's four sums of one column (``kendall.py:17-30``)."""
    dx = jnp.sign(jnp.asarray(x)[:, None] - jnp.asarray(x)[None, :])
    dy = jnp.sign(jnp.asarray(y)[:, None] - jnp.asarray(y)[None, :])
    iu = jnp.triu_indices(len(x), k=1)
    dx, dy = dx[iu], dy[iu]
    return np.array([jnp.sum((dx * dy) > 0), jnp.sum((dx * dy) < 0), jnp.sum(dx == 0), jnp.sum(dy == 0)])


def _count_cases():
    rng = np.random.RandomState(11)
    x = rng.randint(0, 6, N).astype(np.float32)
    y = rng.randint(0, 4, N).astype(np.float32)
    special_x, special_y = x.copy(), y.copy()
    special_x[[1, 5, 9]] = [np.nan, np.inf, np.inf]
    special_y[[2, 5, 7, 9]] = [np.nan, -np.inf, -np.inf, np.inf]
    special_x[[3, 4]] = [-0.0, 0.0]
    return {"ties": (x, y), "inf_nan_zeros": (special_x, special_y), "continuous": data(12)}


@pytest.mark.parametrize("case", sorted(_count_cases()))
def test_pair_counts_bit_equal_to_jax_sums(case):
    x, y = _count_cases()[case]
    got = tk.pair_counts(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int64 and got.shape == (1, 4)
    np.testing.assert_array_equal(got[0].numpy(), jax_pair_counts(x, y))


def test_pair_counts_of_many_columns_and_row_chunks(monkeypatch):
    """Every column counts as it would alone, in one call, and small chunks give the same sums."""
    cases = _count_cases()
    x = np.stack([cases["ties"][0], cases["inf_nan_zeros"][0], cases["continuous"][0]], axis=1)
    y = np.stack([cases["ties"][1], cases["inf_nan_zeros"][1], cases["continuous"][1]], axis=1)
    whole = tk.pair_counts(torch.from_numpy(x), torch.from_numpy(y))
    for j in range(3):
        np.testing.assert_array_equal(whole[j].numpy(), jax_pair_counts(x[:, j], y[:, j]))
    monkeypatch.setattr(tk, "_PLAIN_CHUNK_BYTES", 4 * 3 * N * 7)  # 7 rows a chunk
    assert torch.equal(tk._plain_pair_counts(torch.from_numpy(x), torch.from_numpy(y)), whole)


def test_plain_counts_are_int64_and_chunk_sums_pass_2_to_the_31():
    """Chunk counts whose sum passes 2^31 add exactly: the JAX package's int32 sums
    wrap past n = 65,536 (the value itself at n = 131,072 is checked on the card)."""
    big = (1 << 31) - 5
    chunks = [torch.tensor([[big, 1, 2, 3]], dtype=torch.int64), torch.tensor([[9, big, 7, 1 << 31]])]
    total = tk._sum_chunk_counts(chunks)
    assert total.dtype == torch.int64
    assert total.tolist() == [[(1 << 31) + 4, (1 << 31) - 4, 9, (1 << 31) + 3]]
    n = 300
    ramp = torch.arange(n, dtype=torch.float32)
    counts = tk._plain_pair_counts(ramp, ramp)
    assert counts.dtype == torch.int64 and counts.tolist() == [[n * (n - 1) // 2, 0, 0, 0]]


def test_kendall_counts_denormal_differences_where_xla_flushes_them():
    """A deliberate deviation: XLA's CPU flushes the denormal difference to 0 (a tie);
    the port's float32 difference keeps it (a strict order)."""
    x = np.array([0.0, 1e-40], np.float32)
    y = np.array([0.0, 1.0], np.float32)
    np.testing.assert_array_equal(jax_pair_counts(x, y), [0, 0, 1, 0])
    assert tk.pair_counts(torch.from_numpy(x), torch.from_numpy(y)).tolist() == [[1, 0, 0, 0]]


def test_kendall_p_value_within_1e7_of_scipy_norm():
    from scipy.stats import norm

    tau = torch.tensor([-0.9, -0.2, 0.0, 0.05, 0.7], dtype=torch.float32)
    for alternative in ("two-sided", "less", "greater"):
        from metrics_tpu_torch.functional.regression.kendall import _p_value

        z = tau.double().numpy() / np.sqrt((2 * (2 * 50 + 5)) / (9 * 50 * 49))
        want = {"two-sided": 2 * norm.sf(np.abs(z)), "greater": norm.sf(z), "less": norm.cdf(z)}[alternative]
        np.testing.assert_allclose(_p_value(tau, 50, alternative).numpy(), want, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------- classes

# name, kwargs, input shape, positive, rtol
CLASS_CASES = [
    ("MeanSquaredError", {}, (N,), False, 1e-5),
    ("MeanSquaredError", {"squared": False}, (N,), False, 1e-5),
    ("MeanAbsoluteError", {}, (N,), False, 1e-5),
    ("MeanAbsolutePercentageError", {}, (N,), True, 1e-5),
    ("SymmetricMeanAbsolutePercentageError", {}, (N,), False, 1e-5),
    ("WeightedMeanAbsolutePercentageError", {}, (N,), False, 1e-5),
    ("MeanSquaredLogError", {}, (N,), True, 1e-5),
    ("LogCoshError", {"num_outputs": C}, (N, C), False, 1e-4),
    ("MinkowskiDistance", {"p": 2}, (N,), False, 1e-4),
    ("CosineSimilarity", {"reduction": "mean"}, (N, C), False, 1e-5),
    ("KLDivergence", {}, (N, C), True, 1e-4),
    ("KLDivergence", {"reduction": "none"}, (N, C), True, 1e-4),
    ("ExplainedVariance", {"multioutput": "raw_values"}, (N, C), False, 1e-4),
    ("R2Score", {"num_outputs": C, "multioutput": "raw_values"}, (N, C), False, 1e-4),
    ("R2Score", {"adjusted": 2}, (N,), False, 1e-4),
    ("TweedieDevianceScore", {"power": 1.5}, (N,), True, 1e-5),
    ("PearsonCorrCoef", {}, (N,), False, 1e-4),
    ("PearsonCorrCoef", {"num_outputs": C}, (N, C), False, 1e-4),
    ("ConcordanceCorrCoef", {"num_outputs": C}, (N, C), False, 1e-4),
    ("SpearmanCorrCoef", {}, (N,), False, 1e-4),
    ("SpearmanCorrCoef", {"num_outputs": C}, (N, C), False, 1e-4),
    ("KendallRankCorrCoef", {}, (N,), False, 1e-4),
    ("KendallRankCorrCoef", {"variant": "c", "t_test": True, "num_outputs": C}, (N, C), False, 1e-4),
]


def batches(seed: int, shape, positive: bool, k: int = 3):
    return [data(seed + i, shape, positive) for i in range(k)]


@pytest.mark.parametrize("name,kwargs,shape,positive,rtol", CLASS_CASES, ids=lambda v: str(v))
def test_class_matches_jax(name, kwargs, shape, positive, rtol):
    jmetric = getattr(jr, name)(**kwargs)
    tmetric = getattr(tr, name)(**kwargs, device="cpu")
    for preds, target in batches(len(name), shape, positive):
        want = jmetric(jnp.asarray(preds), jnp.asarray(target))
        got = tmetric(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(got, want, rtol)
    assert_close(tmetric.compute(), jmetric.compute(), rtol)
    tmetric.reset()
    preds, target = data(99, shape, positive)
    tmetric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_close(tmetric.compute(), getattr(jr, name)(**kwargs)(jnp.asarray(preds), jnp.asarray(target)), rtol)


@pytest.mark.parametrize("name", ["SpearmanCorrCoef", "KendallRankCorrCoef"])
def test_cat_capacity_equals_list_states(name):
    from metrics_tpu_torch.core.state import CatBuffer

    listed = getattr(tr, name)(num_outputs=C, device="cpu")
    buffered = getattr(tr, name)(num_outputs=C, cat_capacity=4 * N, device="cpu")
    for preds, target in batches(21, (N, C), False):
        for m in (listed, buffered):
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert isinstance(buffered.preds, CatBuffer) and buffered.preds.data.shape == (4 * N, C)
    assert torch.equal(listed.compute(), buffered.compute())


def test_pearson_final_aggregation_of_stacked_moments_matches_jax():
    """Moments of three processes, stacked as a sync leaves them, merge as the JAX package merges them."""
    stacks_j, stacks_t = [], []
    for k in range(3):
        preds, target = data(30 + k, (N + 7 * k, C))
        jm, tm = jr.PearsonCorrCoef(num_outputs=C), tr.PearsonCorrCoef(num_outputs=C, device="cpu")
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
        stacks_j.append([jm.mean_x, jm.mean_y, jm.var_x, jm.var_y, jm.corr_xy, jm.n_total])
        stacks_t.append([tm.mean_x, tm.mean_y, tm.var_x, tm.var_y, tm.corr_xy, tm.n_total])
    want = jax_final_aggregation(*(jnp.stack(s) for s in zip(*stacks_j)))
    got = _final_aggregation(*(torch.stack(s) for s in zip(*stacks_t)))
    assert_close(tuple(got), tuple(want), 1e-5)
    merged = tr.PearsonCorrCoef(num_outputs=C, device="cpu")
    for name, value in zip(("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"), zip(*stacks_t)):
        setattr(merged, name, torch.stack(value))
    merged._update_count = 1
    union_p = np.concatenate([data(30 + k, (N + 7 * k, C))[0] for k in range(3)])
    union_t = np.concatenate([data(30 + k, (N + 7 * k, C))[1] for k in range(3)])
    assert_close(merged.compute(), jf.pearson_corrcoef(jnp.asarray(union_p), jnp.asarray(union_t)), 1e-4)


def test_stacked_multi_output_pearson_merges_where_jax_does_not():
    """A deliberate deviation: the JAX class tells stacked moments of ``num_outputs > 1``
    by a 3-D shape, which a sync's ``(k, C)`` stack never has, and returns one row per
    process; the port merges them (a 2-D moment is a stack)."""
    preds, target = data(33, (N, C))
    jm, tm = jr.PearsonCorrCoef(num_outputs=C), tr.PearsonCorrCoef(num_outputs=C, device="cpu")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    single = tm.compute()
    for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
        setattr(jm, name, jnp.stack([getattr(jm, name)] * 2))
        setattr(tm, name, torch.stack([getattr(tm, name)] * 2))
    jm._computed = tm._computed = None
    assert np.asarray(jm.compute()).shape == (2, C)
    assert tm.compute().shape == (C,)
    assert_close(tm.compute(), single, 1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("PearsonCorrCoef", {"num_outputs": C}), ("ConcordanceCorrCoef", {"num_outputs": C}),
    ("SpearmanCorrCoef", {"num_outputs": C}), ("KendallRankCorrCoef", {"num_outputs": C}),
    ("KLDivergence", {"reduction": "none"}), ("R2Score", {"num_outputs": C}), ("MeanSquaredError", {}),
])
def test_load_jax_state(name, kwargs):
    """States of an updated JAX metric, loaded into the port, compute the same value."""
    shape = (N, C) if kwargs.get("num_outputs") or name == "KLDivergence" else (N,)
    jmetric = getattr(jr, name)(**kwargs)
    for preds, target in batches(40, shape, name == "KLDivergence", k=2):
        jmetric.update(jnp.asarray(preds), jnp.asarray(target))
    jmetric.persistent(True)
    tmetric = load_jax_state(getattr(tr, name)(**kwargs, device="cpu"), jmetric.state_dict())
    assert_close(tmetric.compute(), jmetric.compute(), 1e-4)


def test_load_jax_state_of_stacked_pearson_moments():
    """A synced JAX Pearson state, (k, C) per moment, loads stacked and merges at compute."""
    jm = jr.PearsonCorrCoef(num_outputs=C)
    preds, target = data(50, (N, C))
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    jm.persistent(True)
    state = {k: np.stack([np.asarray(v)] * 2) for k, v in jm.state_dict().items()}
    tm = load_jax_state(tr.PearsonCorrCoef(num_outputs=C, device="cpu"), state)
    assert tm.mean_x.shape == (2, C)
    doubled = jf.pearson_corrcoef(jnp.asarray(np.concatenate([preds] * 2)), jnp.asarray(np.concatenate([target] * 2)))
    assert_close(tm.compute(), doubled, 1e-4)


# ------------------------------------------------------------------------ errors


def _raises_same(jax_call, torch_call):
    with pytest.raises(Exception) as jexc:
        jax_call()
    with pytest.raises(Exception) as texc:
        torch_call()
    assert type(texc.value).__name__ == type(jexc.value).__name__, (texc.value, jexc.value)
    assert str(texc.value).replace("metrics_tpu_torch", "metrics_tpu") == str(jexc.value), (texc.value, jexc.value)


ERROR_CASES = [
    ("tweedie_deviance_score", (1.0,), {"power": 0.5}, False),
    ("tweedie_deviance_score", (-1.0,), {"power": 1}, False),
    ("tweedie_deviance_score", (-1.0,), {"power": 2}, False),
    ("tweedie_deviance_score", (-1.0,), {"power": -2}, False),
    ("tweedie_deviance_score", (-1.0,), {"power": 1.5}, False),
    ("tweedie_deviance_score", (-1.0,), {"power": 3}, False),
    ("minkowski_distance", (1.0,), {"p": 0.5}, False),
    ("kendall_rank_corrcoef", (1.0,), {"variant": "d"}, False),
    ("kendall_rank_corrcoef", (1.0,), {"t_test": True, "alternative": "both"}, False),
    ("explained_variance", (1.0,), {"multioutput": "bad"}, False),
    ("r2_score", (1.0,), {"multioutput": "bad"}, False),
    ("kl_divergence", (1.0,), {}, False),
    ("spearman_corrcoef", (1.0,), {}, True),
    ("pearson_corrcoef", (1.0,), {}, "3d"),
    ("mean_squared_error", (1.0,), {}, "shape"),
]


@pytest.mark.parametrize("name,scale,kwargs,variant", ERROR_CASES, ids=lambda v: str(v))
def test_errors_match_jax(name, scale, kwargs, variant):
    preds, target = data(60)
    preds = preds * scale[0]
    if variant is True:  # integer inputs
        preds, target = preds.astype(np.int32), target.astype(np.int32)
    elif variant == "3d":
        preds, target = preds.reshape(2, 4, 5), target.reshape(2, 4, 5)
    elif variant == "shape":
        target = target[:-1]
    if name == "minkowski_distance":
        kwargs = dict(kwargs)
        p = kwargs.pop("p")
        _raises_same(lambda: getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), p),
                     lambda: getattr(tf, name)(preds, target, p, device="cpu"))
        return
    _raises_same(lambda: getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                 lambda: getattr(tf, name)(preds, target, **kwargs, device="cpu"))


CLASS_ERROR_CASES = [
    ("KendallRankCorrCoef", {"variant": "x"}), ("KendallRankCorrCoef", {"t_test": 1}),
    ("KendallRankCorrCoef", {"t_test": True, "alternative": None}), ("KLDivergence", {"log_prob": 1}),
    ("KLDivergence", {"reduction": "avg"}), ("R2Score", {"adjusted": -1}), ("R2Score", {"multioutput": "x"}),
    ("ExplainedVariance", {"multioutput": "x"}), ("MeanSquaredError", {"squared": 1}),
    ("MinkowskiDistance", {"p": 0}), ("TweedieDevianceScore", {"power": 0.5}), ("LogCoshError", {"num_outputs": 0}),
    ("CosineSimilarity", {"reduction": "max"}), ("PearsonCorrCoef", {"num_outputs": 0}),
    ("SpearmanCorrCoef", {"num_outputs": 0}),
]


@pytest.mark.parametrize("name,kwargs", CLASS_ERROR_CASES, ids=lambda v: str(v))
def test_class_argument_errors_match_jax(name, kwargs):
    _raises_same(lambda: getattr(jr, name)(**kwargs), lambda: getattr(tr, name)(**kwargs, device="cpu"))


def test_minkowski_error_is_a_metrics_user_error():
    with pytest.raises(MetricsUserError):
        tf.minkowski_distance(np.ones(3, np.float32), np.ones(3, np.float32), 0.5, device="cpu")


# ------------------------------------------------------------ names and shims


@pytest.mark.parametrize("module,port", [(jr, tr), (jf, tf)], ids=["regression", "functional.regression"])
def test_every_public_name_exists_in_the_port(module, port):
    assert set(port.__all__) == set(module.__all__)
    assert not [n for n in module.__all__ if not hasattr(port, n)]


def test_root_exports_match_the_jax_root_for_regression():
    for name in jr.__all__:
        assert (name in metrics_tpu.__all__) == (name in metrics_tpu_torch.__all__), name
        assert hasattr(metrics_tpu_torch, name)
    for name in jf.__all__:
        assert hasattr(jfr, name) and hasattr(tfr, name), name


def test_regression_root_names_do_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        metrics_tpu_torch.MeanSquaredError(device="cpu")
        tfr.mean_squared_error(np.ones(2, np.float32), np.zeros(2, np.float32), device="cpu")
