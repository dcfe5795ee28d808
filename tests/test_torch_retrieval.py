"""The retrieval family of metrics_tpu_torch against metrics_tpu, on the CPU.

The same seeded numpy inputs go through both packages (``device="cpu"`` for the
port, whose integer scans then take the plain multi-scan, the CUDA kernel's
reference). ``grouped_retrieval_scores`` is compared row by row: ``n_positive``
and ``valid`` bit-equal, the scores within rtol 1e-6. AP and NDCG read their
scores as differences of in-block running sums, which both packages take in
another order (XLA's CPU cumsum is an associative scan, PyTorch's a running sum):
their scores may differ by a few ulps of the largest in-block sum, so they also
get an absolute tolerance of 4 such ulps (``_float_scan_atol``). Class values agree within rtol 1e-6, tighter than the JAX
package's own retrieval tests (1e-5, NDCG 1e-4); the single-query functionals
likewise.

Inputs: binary and graded targets, scores rounded through bfloat16 (long ties),
scores of 0.0, -0.0 and denormals (one tie class under XLA's sort, as under the
port's key), NaN scores, single-row queries, query ids interleaved across updates,
``ignore_index`` rows. One case runs the JAX side's scans through the Pallas kernel
in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import retrieval as jr
from metrics_tpu.functional import retrieval as jf
from metrics_tpu.ops.segment import force_scan_impl
from metrics_tpu.ops.segment import grouped_retrieval_scores as j_grouped
from metrics_tpu_torch import retrieval as tr
from metrics_tpu_torch.functional import retrieval as tf
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.ops.rank import ranked_targets, stable_front_pack
from metrics_tpu_torch.ops.segment import grouped_retrieval_scores
from tests.torch_deadline import deadline  # noqa: F401

_j_grouped = jax.jit(j_grouped, static_argnames=("metric", "top_k", "adaptive_k"))

N_ROWS = 600
N_QUERIES = 70
DENORMALS = np.array([0.0, -0.0, 1e-40, -1e-40, 3e-39, 0.25, -0.25, 1.0], np.float32)


def _bf16(x):
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).to(torch.float32).numpy()


def _inputs(kind, seed, graded=False, n=N_ROWS):
    """``(indexes, preds, target)`` as numpy arrays of one input kind."""
    rng = np.random.RandomState(seed)
    indexes = rng.randint(0, N_QUERIES, n)
    if kind == "single_rows":
        indexes = rng.permutation(n)
    preds = rng.rand(n).astype(np.float32)
    if kind == "bf16_ties":
        preds = _bf16(rng.randn(n) * 0.05)
    elif kind == "zeros_denormals":
        preds = DENORMALS[rng.randint(0, len(DENORMALS), n)]
    elif kind == "nan":
        preds = np.where(rng.rand(n) < 0.1, np.nan, preds).astype(np.float32)
    if graded:
        target = rng.randint(0, 4, n) * (rng.rand(n) < 0.4)
    else:
        target = (rng.rand(n) < 0.25).astype(np.int64)
    return indexes, preds, target


KINDS = ("random", "bf16_ties", "zeros_denormals", "nan", "single_rows")
METRICS = (
    "average_precision", "reciprocal_rank", "precision", "recall", "hit_rate", "fall_out", "ndcg", "r_precision",
)


def _float_scan_atol(metric, target):
    """4 ulps of the largest in-block running sum of AP's or NDCG's float stream
    (each term is at most the row's target), 0 for the integer-only metrics."""
    if metric not in ("average_precision", "ndcg"):
        return 0.0
    return 4 * float(np.spacing(np.float32(np.abs(target).sum())))


def _assert_rows(got, want, atol=0.0):
    scores, n_pos, valid = (t.numpy() for t in got)
    w_scores, w_n_pos, w_valid = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(n_pos, w_n_pos)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("metric", METRICS)
def test_grouped_scores_row_by_row(metric, kind):
    indexes, preds, target = _inputs(kind, seed=len(kind) + len(metric), graded=metric == "ndcg")
    top_k = None if kind in ("random", "nan") else 3
    if metric in ("reciprocal_rank", "r_precision"):
        top_k = None
    got = grouped_retrieval_scores(
        torch.tensor(indexes, dtype=torch.int32), torch.tensor(preds), torch.tensor(target, dtype=torch.int32),
        metric, top_k=top_k,
    )
    want = _j_grouped(jnp.asarray(indexes, jnp.int32), jnp.asarray(preds), jnp.asarray(target, jnp.int32),
                      metric=metric, top_k=top_k)
    _assert_rows(got, want, _float_scan_atol(metric, target))


@pytest.mark.parametrize("metric", ["precision", "recall", "hit_rate", "average_precision", "ndcg"])
@pytest.mark.parametrize("top_k", [1, 10])
def test_grouped_scores_top_k(metric, top_k):
    indexes, preds, target = _inputs("bf16_ties", seed=top_k, graded=metric == "ndcg")
    for adaptive_k in ((False, True) if metric == "precision" else (False,)):
        got = grouped_retrieval_scores(
            torch.tensor(indexes, dtype=torch.int32), torch.tensor(preds), torch.tensor(target, dtype=torch.int32),
            metric, top_k=top_k, adaptive_k=adaptive_k,
        )
        want = _j_grouped(jnp.asarray(indexes, jnp.int32), jnp.asarray(preds), jnp.asarray(target, jnp.int32),
                          metric=metric, top_k=top_k, adaptive_k=adaptive_k)
        _assert_rows(got, want, _float_scan_atol(metric, target))


def test_grouped_scores_graded_float_targets_and_fill_rows():
    """NDCG's ideal sort on float targets, and CatBuffer fill rows (index -1) mixed in."""
    indexes, preds, target = _inputs("bf16_ties", seed=7, graded=True)
    target = (target * 0.5).astype(np.float32)
    indexes = np.where(np.random.RandomState(8).rand(len(indexes)) < 0.1, -1, indexes)
    for top_k in (None, 3):
        got = grouped_retrieval_scores(
            torch.tensor(indexes, dtype=torch.int32), torch.tensor(preds), torch.tensor(target), "ndcg", top_k=top_k
        )
        want = _j_grouped(jnp.asarray(indexes, jnp.int32), jnp.asarray(preds), jnp.asarray(target),
                          metric="ndcg", top_k=top_k)
        _assert_rows(got, want, _float_scan_atol("ndcg", target))


@pytest.mark.parametrize("metric", ["reciprocal_rank", "r_precision", "precision"])
def test_grouped_scores_against_pallas_interpret(metric):
    """The JAX side's integer scans through the Pallas kernel in interpret mode."""
    indexes, preds, target = _inputs("bf16_ties", seed=11, n=3000)
    top_k = 10 if metric == "precision" else None
    got = grouped_retrieval_scores(
        torch.tensor(indexes, dtype=torch.int32), torch.tensor(preds), torch.tensor(target, dtype=torch.int32),
        metric, top_k=top_k,
    )
    with force_scan_impl("pallas_interpret"):
        want = j_grouped(jnp.asarray(indexes, jnp.int32), jnp.asarray(preds), jnp.asarray(target, jnp.int32),
                         metric, top_k=top_k)
    _assert_rows(got, want)


def test_grouped_scores_rejects_unknown_metric():
    with pytest.raises(ValueError, match="Unknown grouped retrieval metric"):
        grouped_retrieval_scores(torch.zeros(3, dtype=torch.int32), torch.zeros(3), torch.zeros(3), "mystery")


def test_segment_cumsum_helpers_match_jax():
    from metrics_tpu.ops import segment as js

    rng = np.random.RandomState(3)
    n = 5000
    flags = rng.rand(n) < 0.01
    flags[0] = True
    ints = rng.randint(0, 5, n).astype(np.int32)
    floats = (rng.randn(n) * 3).astype(np.float32)
    tflags = torch.tensor(flags)
    np.testing.assert_array_equal(
        segment._segment_cumsum_nonneg(torch.tensor(ints), tflags).numpy(),
        np.asarray(js._segment_cumsum_nonneg(jnp.asarray(ints), jnp.asarray(flags))),
    )
    is_last = np.append(flags[1:], True)
    np.testing.assert_array_equal(
        segment._segment_suffix_sum_nonneg(torch.tensor(ints), torch.tensor(is_last)).numpy(),
        np.asarray(js._segment_suffix_sum_nonneg(jnp.asarray(ints), jnp.asarray(is_last))),
    )
    f64 = floats.astype(np.float64)
    start = np.maximum.accumulate(np.where(flags, np.arange(n), 0))
    ref = np.cumsum(f64) - (np.cumsum(f64)[start] - f64[start])  # float64 per-segment running sums
    for block in (2048, 64):  # 64: the carry crosses many blocks
        got = segment._segment_cumsum_float(torch.tensor(floats), tflags, block=block).numpy()
        want = np.asarray(js._segment_cumsum_float(jnp.asarray(floats), jnp.asarray(flags), block=block))
        # both read differences of in-block running sums of |v|: 4 ulps of the largest
        atol = 4 * float(np.spacing(np.float32(np.abs(floats[:block]).sum())))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)


# ---------------------------------------------------------------- classes

CLASS_NAMES = (
    "RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalPrecision", "RetrievalRecall",
    "RetrievalHitRate", "RetrievalFallOut", "RetrievalRPrecision",
)
TOP_K_CLASSES = ("RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalPrecision", "RetrievalRecall")


def _pair(name, **kwargs):
    return getattr(jr, name)(**kwargs), getattr(tr, name)(device="cpu", **kwargs)


def _run(pair, indexes, preds, target, chunks=4):
    """Update both metrics in ``chunks`` updates; return both values."""
    jm, tm = pair
    for part in np.array_split(np.arange(len(indexes)), chunks):
        jm.update(jnp.asarray(preds[part]), jnp.asarray(target[part]), indexes=jnp.asarray(indexes[part]))
        tm.update(torch.tensor(preds[part]), torch.tensor(target[part]), indexes=torch.tensor(indexes[part]))
    return np.asarray(jm.compute()), tm.compute().numpy()


@pytest.mark.parametrize("empty_target_action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name", CLASS_NAMES)
def test_class_matches_jax(name, empty_target_action):
    indexes, preds, target = _inputs("bf16_ties", seed=len(name), graded=name == "RetrievalNormalizedDCG")
    want, got = _run(_pair(name, empty_target_action=empty_target_action), indexes, preds, target)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 3, 10])
@pytest.mark.parametrize("name", TOP_K_CLASSES)
def test_class_top_k_matches_jax(name, top_k):
    indexes, preds, target = _inputs("random", seed=top_k, graded=name == "RetrievalNormalizedDCG")
    want, got = _run(_pair(name, top_k=top_k), indexes, preds, target)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("RetrievalPrecision", {"top_k": 10, "adaptive_k": True}),
    ("RetrievalPrecision", {"top_k": 3, "adaptive_k": True}),
    ("RetrievalHitRate", {"top_k": 3}),
    ("RetrievalFallOut", {"top_k": 3}),
    ("RetrievalFallOut", {"empty_target_action": "neg"}),
])
def test_class_options_match_jax(name, kwargs):
    indexes, preds, target = _inputs("zeros_denormals", seed=5)
    want, got = _run(_pair(name, **kwargs), indexes, preds, target)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", CLASS_NAMES)
def test_class_ignore_index_and_interleaved_updates(name):
    """Rows with target -100 are dropped; every query's rows span several updates."""
    indexes, preds, target = _inputs("random", seed=21, graded=name == "RetrievalNormalizedDCG")
    target = np.where(np.random.RandomState(22).rand(len(target)) < 0.15, -100, target)
    order = np.argsort(np.arange(len(indexes)) % 7, kind="stable")  # interleave the queries' rows
    indexes, preds, target = indexes[order], preds[order], target[order]
    want, got = _run(_pair(name, ignore_index=-100), indexes, preds, target, chunks=7)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", CLASS_NAMES)
def test_class_single_row_queries(name):
    indexes, preds, target = _inputs("single_rows", seed=31, n=200)
    want, got = _run(_pair(name), indexes, preds, target)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", CLASS_NAMES)
def test_class_error_action(name):
    """``error`` raises on a query without positives (fall-out: without negatives);
    with none, it gives the mean over all queries, JAX's ``neg`` value there."""
    rng = np.random.RandomState(41)
    indexes = np.repeat(np.arange(12), 6)
    preds = _bf16(rng.randn(indexes.size))
    target = np.tile([1, 0, 0, 1, 0, 0], 12)
    negatives = name == "RetrievalFallOut"
    kind = "negative" if negatives else "positive"
    _, tm = _pair(name, empty_target_action="error")
    empty = np.where(indexes == 3, int(negatives), target)  # query 3 all relevant / all not
    tm.update(torch.tensor(preds), torch.tensor(empty), indexes=torch.tensor(indexes))
    with pytest.raises(ValueError, match=f"no {kind} target"):
        tm.compute()
    jm, tm = getattr(jr, name)(), getattr(tr, name)(empty_target_action="error", device="cpu")
    want, got = _run((jm, tm), indexes, preds, target, chunks=2)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_class_graded_float_targets():
    indexes, preds, target = _inputs("bf16_ties", seed=51, graded=True)
    target = (target * 0.75).astype(np.float32)
    for top_k in (None, 3):
        want, got = _run(_pair("RetrievalNormalizedDCG", top_k=top_k), indexes, preds, target)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_class_argument_checks():
    for name in CLASS_NAMES:
        with pytest.raises(ValueError, match="empty_target_action"):
            getattr(tr, name)(empty_target_action="maybe", device="cpu")
        with pytest.raises(ValueError, match="ignore_index"):
            getattr(tr, name)(ignore_index=0.5, device="cpu")
    for name in TOP_K_CLASSES + ("RetrievalHitRate", "RetrievalFallOut"):
        with pytest.raises(ValueError, match="top_k"):
            getattr(tr, name)(top_k=0, device="cpu")
    with pytest.raises(ValueError, match="adaptive_k"):
        tr.RetrievalPrecision(adaptive_k=1, device="cpu")
    m = tr.RetrievalMAP(device="cpu")
    with pytest.raises(ValueError, match="indexes"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.int64), None)
    with pytest.raises(ValueError, match="non-negative"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.int64), torch.tensor([0, -1, 2]))
    with pytest.raises(ValueError, match="binary"):
        m.update(torch.rand(3), torch.tensor([0, 2, 1]), torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match="booleans or integers"):
        m.update(torch.rand(3), torch.rand(3), torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match="same shape"):
        m.update(torch.rand(3), torch.ones(2, dtype=torch.int64), torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match="integers"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.int64), torch.rand(3))


def test_class_forward_returns_the_batch_value():
    indexes, preds, target = _inputs("random", seed=61)
    jm, tm = _pair("RetrievalMAP")
    for part in np.array_split(np.arange(len(indexes)), 3):
        want = jm(jnp.asarray(preds[part]), jnp.asarray(target[part]), indexes=jnp.asarray(indexes[part]))
        got = tm(torch.tensor(preds[part]), torch.tensor(target[part]), indexes=torch.tensor(indexes[part]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=1e-6)


# ------------------------------------------------------ precision-recall curve


@pytest.mark.parametrize("kwargs", [
    {}, {"max_k": 4}, {"max_k": 30, "adaptive_k": True}, {"empty_target_action": "pos"},
    {"empty_target_action": "skip", "max_k": 5}, {"ignore_index": -100},
])
def test_precision_recall_curve_class_matches_jax(kwargs):
    indexes, preds, target = _inputs("zeros_denormals", seed=71, n=300)
    if "ignore_index" in kwargs:
        target = np.where(np.random.RandomState(72).rand(len(target)) < 0.1, -100, target)
    jm, tm = _pair("RetrievalPrecisionRecallCurve", **kwargs)
    for part in np.array_split(np.arange(len(indexes)), 3):
        jm.update(jnp.asarray(preds[part]), jnp.asarray(target[part]), indexes=jnp.asarray(indexes[part]))
        tm.update(torch.tensor(preds[part]), torch.tensor(target[part]), indexes=torch.tensor(indexes[part]))
    for got, want in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("min_precision", [0.0, 0.3, 0.8, 1.0])
def test_recall_at_fixed_precision_matches_jax(min_precision):
    indexes, preds, target = _inputs("bf16_ties", seed=81, n=300)
    jm, tm = _pair("RetrievalRecallAtFixedPrecision", min_precision=min_precision, max_k=8)
    jm.update(jnp.asarray(preds), jnp.asarray(target), indexes=jnp.asarray(indexes))
    tm.update(torch.tensor(preds), torch.tensor(target), indexes=torch.tensor(indexes))
    (got_r, got_k), (want_r, want_k) = tm.compute(), jm.compute()
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-6)
    assert int(got_k) == int(want_k)


def test_precision_recall_curve_error_action():
    _, tm = _pair("RetrievalPrecisionRecallCurve", empty_target_action="error")
    tm.update(torch.rand(4), torch.tensor([0, 0, 1, 0]), indexes=torch.tensor([0, 0, 1, 1]))
    with pytest.raises(ValueError, match="no positive target"):
        tm.compute()


# ------------------------------------------------------------- functionals

FUNCTIONALS = {
    "retrieval_average_precision": [{}, {"top_k": 2}, {"top_k": 50}],
    "retrieval_reciprocal_rank": [{}],
    "retrieval_precision": [{}, {"top_k": 3}, {"top_k": 50, "adaptive_k": True}, {"top_k": 50}],
    "retrieval_recall": [{}, {"top_k": 3}],
    "retrieval_hit_rate": [{}, {"top_k": 1}],
    "retrieval_fall_out": [{}, {"top_k": 3}],
    "retrieval_normalized_dcg": [{}, {"top_k": 3}],
    "retrieval_r_precision": [{}],
}
FUNCTIONAL_CASES = [(name, kw) for name, kws in FUNCTIONALS.items() for kw in kws]


@pytest.mark.parametrize("kind", ["random", "bf16_ties", "zeros_denormals", "nan", "no_positive"])
@pytest.mark.parametrize("name,kwargs", FUNCTIONAL_CASES, ids=lambda v: str(v))
def test_functional_matches_jax(name, kwargs, kind):
    _, preds, target = _inputs("random" if kind == "no_positive" else kind, seed=len(name) + len(kind), n=40,
                               graded=name == "retrieval_normalized_dcg")
    if kind == "no_positive":
        target = np.zeros_like(target)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, name)(torch.tensor(preds), torch.tensor(target), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"max_k": 3}, {"max_k": 60, "adaptive_k": True}, {"max_k": 60}])
@pytest.mark.parametrize("kind", ["random", "zeros_denormals"])
def test_functional_precision_recall_curve_matches_jax(kwargs, kind):
    _, preds, target = _inputs(kind, seed=91, n=40)
    for got, want in zip(tf.retrieval_precision_recall_curve(torch.tensor(preds), torch.tensor(target), **kwargs),
                         jf.retrieval_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), **kwargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_functional_checks():
    with pytest.raises(ValueError, match="same shape"):
        tf.retrieval_recall(torch.rand(3), torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="non-empty"):
        tf.retrieval_recall(torch.rand(0), torch.ones(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="binary"):
        tf.retrieval_recall(torch.rand(3), torch.tensor([0, 3, 1]))
    with pytest.raises(ValueError, match="top_k"):
        tf.retrieval_recall(torch.rand(3), torch.tensor([0, 1, 1]), top_k=0)
    # graded targets are NDCG's only
    tf.retrieval_normalized_dcg(torch.rand(3), torch.tensor([0.5, 3.0, 1.0]))
    with pytest.raises(ValueError, match="booleans or integers"):
        tf.retrieval_precision(torch.rand(3), torch.tensor([0.5, 3.0, 1.0]))


# ---------------------------------------------------------------- rank helpers


@pytest.mark.parametrize("kind", ["random", "bf16_ties", "zeros_denormals", "nan"])
def test_ranked_targets_matches_jax(kind):
    from metrics_tpu.ops.rank import ranked_targets as j_ranked_targets

    _, preds, target = _inputs(kind, seed=101)
    got = ranked_targets(torch.tensor(preds), torch.tensor(np.arange(len(preds))))
    want = j_ranked_targets(jnp.asarray(preds), jnp.asarray(np.arange(len(preds), dtype=np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_stable_front_pack_matches_jax(p):
    from metrics_tpu.ops.rank import stable_front_pack as j_stable_front_pack

    rng = np.random.RandomState(int(p * 10))
    mask = rng.rand(257) < p
    a, b = rng.randint(-9, 9, 257).astype(np.int32), rng.rand(257).astype(np.float32)
    got = stable_front_pack(torch.tensor(mask), torch.tensor(a), torch.tensor(b))
    want = j_stable_front_pack(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
