"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and nvcc (the kernels have no CPU mode): each is
marked ``cuda`` and skips elsewhere. The file imports neither JAX nor metrics_tpu,
so that it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py
"""
import pytest
import torch

from metrics_tpu_torch.ops import histogram


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the histogram kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("bins", [1, 25, 361, 2048, 16384])
def test_kernel_matches_plain_on_card(cuda, bins, n):
    g = torch.Generator(device=cuda).manual_seed(bins + n)
    ids = torch.randint(-3, bins + 3, (n,), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.rand(n, generator=g, device=cuda) < 0.7
    w = torch.randn(n, generator=g, device=cuda)
    for weights in (None, mask):
        assert torch.equal(histogram.histogram_cuda(ids, weights, bins), histogram._plain_bincount(ids, weights, bins))
    got = histogram.histogram_cuda(ids, w, bins).double()
    want = histogram._plain_bincount(ids, w.double(), bins)
    scale = histogram._plain_bincount(ids, w.abs().double(), bins)
    assert bool(torch.all((got - want).abs() <= 1e-5 * scale))  # atomics add in no fixed order


@pytest.mark.cuda
def test_kernel_wrapper_checks_and_counts(cuda):
    ids = torch.arange(10, device=cuda, dtype=torch.int32)
    before = histogram.histogram_cuda.launches
    histogram.bincount(ids, 16)
    assert histogram.histogram_cuda.launches == before + 1
    with pytest.raises(ValueError):
        histogram.histogram_cuda(ids.long(), None, 16)
    with pytest.raises(TypeError):
        histogram.histogram_cuda(ids, torch.ones(10, device=cuda, dtype=torch.float64), 16)
    with pytest.raises(ValueError):
        histogram.histogram_cuda(ids, None, histogram.KERNEL_MAX_BINS + 1)
