"""The pairwise similarities and distances of metrics_tpu_torch against metrics_tpu,
on the CPU, within 1e-5 relative (1e-6 absolute for values near 0).

The same seeded numpy inputs go through both packages over every argument: ``y``
given or not, ``reduction``, ``zero_diagonal``, the minkowski exponent, float32 and
float64 inputs. The port's manhattan and minkowski distances sum in chunks of rows
(the JAX package builds the whole ``(N, M, d)`` difference tensor): one-row chunks
give the same values as a single chunk. The checks on the card are in
``tests/test_torch_image_card.py``, which imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.pairwise as jp
import metrics_tpu_torch.functional.pairwise as tp
from metrics_tpu_torch.functional.pairwise import helpers
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.torch_deadline import deadline  # noqa: F401

REL = 1e-5
ABS = 1e-6
FUNCTIONS = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]


def inputs(seed, n=9, m=6, d=5, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) * 2).astype(dtype), (rng.randn(m, d) * 2).astype(dtype)


def run_both(name, x, y, **kwargs):
    want = getattr(jp, name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kwargs)
    got = getattr(tp, name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("reduction", [None, "mean", "sum", "none"])
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
def test_pairwise_matches_jax(name, with_y, reduction, zero_diagonal):
    x, y = inputs(0)
    got, want = run_both(name, x, y if with_y else None, reduction=reduction, zero_diagonal=zero_diagonal)
    assert got.shape == want.shape
    atol = ABS
    if name == "pairwise_euclidean_distance" and not with_y and zero_diagonal is False:
        # the kept self-distance sqrt(|x|^2 + |x|^2 - 2 x.x) is the square root of
        # rounding noise in both packages (see test_euclidean_self_distance_diagonal)
        atol = _self_distance_bound(x).max()
    np.testing.assert_allclose(got, want, rtol=REL, atol=atol)


def _self_distance_bound(x):
    """4 sqrt(eps) |x_i|: the float32 rounding of |x_i|^2 + |x_i|^2 - 2 x_i.x_i is a few
    ulps of |x_i|^2, and its square root at most this."""
    return 4 * np.sqrt(np.finfo(np.float32).eps) * np.linalg.norm(x.astype(np.float64), axis=1)


def test_euclidean_self_distance_diagonal():
    x, _ = inputs(0)
    got, want = run_both("pairwise_euclidean_distance", x, None, zero_diagonal=False)
    bound = _self_distance_bound(x)
    assert np.all(np.diag(got) <= bound) and np.all(np.diag(want) <= bound)
    off = ~np.eye(len(x), dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=REL, atol=ABS)


@pytest.mark.parametrize("exponent", [1, 1.5, 2, 3, 4.0])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_minkowski_exponents_and_dtypes(exponent, dtype):
    x, y = inputs(1, dtype=dtype)
    got, want = run_both("pairwise_minkowski_distance", x, y, exponent=exponent)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want.astype(dtype), rtol=REL, atol=ABS)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_float64_inputs(name):
    x, y = inputs(2, dtype=np.float64)
    got = getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(getattr(jp, name)(jnp.asarray(x), jnp.asarray(y)))  # float32 without x64
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=REL, atol=ABS)


@pytest.mark.parametrize("name", ["pairwise_manhattan_distance", "pairwise_minkowski_distance"])
def test_row_chunks_equal_one_chunk(monkeypatch, name):
    x, y = inputs(3, n=17, m=11, d=7)
    whole = getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    monkeypatch.setattr(helpers, "_CHUNK_BYTES", 1)  # one row per chunk
    chunked = getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(chunked, whole)
    monkeypatch.setattr(helpers, "_CHUNK_BYTES", 3 * 11 * 7 * 4)  # three rows, a ragged last chunk
    np.testing.assert_array_equal(getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y)).numpy(), whole)


def test_doc_examples_match_jax():
    x = np.array([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]], np.float32)
    y = np.array([[1.0, 0.0], [2.0, 1.0]], np.float32)
    for name in FUNCTIONS:
        got, want = run_both(name, x, y)
        np.testing.assert_allclose(got, want, rtol=REL, atol=ABS)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_input_errors_match(name):
    x, y = inputs(4)
    for module, array in ((jp, jnp.asarray), (tp, torch.from_numpy)):
        with pytest.raises(ValueError, match="2D tensor"):
            getattr(module, name)(array(x[0]))
        with pytest.raises(ValueError, match="2D tensor"):
            getattr(module, name)(array(x), array(y[:, :3]))
        with pytest.raises(ValueError, match="reduction"):
            getattr(module, name)(array(x), reduction="max")


def test_minkowski_exponent_below_one_raises():
    x, _ = inputs(5)
    import metrics_tpu.utils.exceptions as jax_exceptions

    with pytest.raises(jax_exceptions.MetricsUserError):
        jp.pairwise_minkowski_distance(jnp.asarray(x), exponent=0.5)
    with pytest.raises(MetricsUserError):
        tp.pairwise_minkowski_distance(torch.from_numpy(x), exponent=0.5)


def test_numpy_input_needs_a_device(monkeypatch):
    x, y = inputs(6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.pairwise_euclidean_distance(x, y)
    got = tp.pairwise_euclidean_distance(x, y, device="cpu")
    assert got.device.type == "cpu"
