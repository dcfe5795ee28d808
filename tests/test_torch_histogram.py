"""metrics_tpu_torch.ops.histogram against metrics_tpu.ops.histogram.

The port's plain version (the path of every CPU tensor) is held against the JAX
package's Pallas kernel, run in interpret mode as the JAX package's own tests run it
on the CPU, and against its dispatcher. Integer counts must be bit-equal; float32
weights agree to atol 1e-2, the tolerance of the JAX package's own histogram tests
(tests/unittests/parallel/test_histogram.py). The CUDA kernel itself is held against
the plain version in tests/test_torch_kernels.py, which runs only on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops import histogram as jax_histogram
from metrics_tpu_torch.ops import histogram
from metrics_tpu_torch.utils.data import _bincount, _bincount_weighted
from tests.torch_deadline import deadline  # noqa: F401

BINS = [1, 5, 25, 361, 2048]
SIZES = [100, (1 << 15) + 17]


def _ids(rng, bins, n):
    return rng.randint(-3, bins + 3, n).astype(np.int32)  # includes negative and out-of-range ids


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bins", BINS)
def test_count_matches_pallas_interpret(bins, n):
    x = _ids(np.random.RandomState(bins * 7 + n), bins, n)
    want = np.asarray(jax_histogram._pallas_bincount(jnp.asarray(x), None, bins, interpret=True))
    got = histogram.bincount(torch.from_numpy(x), bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histogram.bincount(jnp.asarray(x), bins)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bins", BINS)
def test_bool_mask_matches_pallas_interpret(bins, n):
    rng = np.random.RandomState(bins * 11 + n)
    x, mask = _ids(rng, bins, n), rng.rand(n) < 0.6
    # the JAX confusion path passes the mask as float32 weights (ops/confmat.py:83)
    want = jax_histogram._pallas_bincount(jnp.asarray(x), jnp.asarray(mask, jnp.float32), bins, interpret=True)
    got = histogram.bincount_weighted(torch.from_numpy(x), torch.from_numpy(mask), bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bins", BINS)
def test_f32_weights_match_pallas_interpret(bins, n):
    rng = np.random.RandomState(bins * 13 + n)
    x, w = _ids(rng, bins, n), rng.rand(n).astype(np.float32)
    want = jax_histogram._pallas_bincount(jnp.asarray(x), jnp.asarray(w), bins, interpret=True)
    got = histogram.bincount_weighted(torch.from_numpy(x), torch.from_numpy(w), bins)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_histogram.bincount_weighted(jnp.asarray(x), jnp.asarray(w), bins)), atol=1e-2
    )


def test_drops_negative_and_out_of_range_ids():
    x = torch.tensor([0, 3, 7, 8, 100, -1, -100] * 10)
    np.testing.assert_array_equal(_bincount(x, 8).numpy(), [10, 0, 0, 10, 0, 0, 0, 10])
    w = torch.full((70,), 0.5)
    np.testing.assert_allclose(_bincount_weighted(x, w, 8).numpy(), [5, 0, 0, 5, 0, 0, 0, 5])


def test_large_bin_counts_take_the_plain_path_on_cpu():
    rng = np.random.RandomState(3)
    bins = histogram.KERNEL_MAX_BINS + 5
    x = rng.randint(-2, bins + 2, 5000)
    want = np.bincount(x[(x >= 0) & (x < bins)], minlength=bins)
    np.testing.assert_array_equal(_bincount(torch.from_numpy(x), bins).numpy(), want)


def test_cpu_dispatch_never_touches_the_kernel():
    before = histogram.histogram_cuda.launches
    histogram.bincount(torch.arange(10), 4)
    histogram.bincount_weighted(torch.arange(10), torch.ones(10, dtype=torch.bool), 4)
    assert histogram.histogram_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        histogram.histogram_cuda(torch.zeros(4, dtype=torch.int32), None, 4)
