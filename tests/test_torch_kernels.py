"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and nvcc (the kernels have no CPU mode): each is
marked ``cuda`` and skips elsewhere. The file imports neither JAX nor metrics_tpu,
so that it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py
"""
import pytest
import torch

from metrics_tpu_torch.ops import histogram, segment


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
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


def _scan_lanes(cuda, g, n, dtype, ops):
    info = torch.iinfo(dtype)
    lanes = []
    for op in ops:
        v = torch.randint(-1000, 1000, (n,), generator=g, device=cuda, dtype=dtype)
        if op != "sum":  # the type's extremes, which are the min/max identities
            pick = torch.rand(n, generator=g, device=cuda)
            v = torch.where(pick < 0.05, info.max, torch.where(pick > 0.95, info.min, v)).to(dtype)
        lanes.append(v)
    return lanes


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("flags", ["none", "p01", "every1000", "all"])
@pytest.mark.parametrize("n", [1, 1000, 2048, 2049, (1 << 20) + 17])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_segment_scan_kernel_matches_plain_on_card(cuda, dtype, n, flags, reverse):
    g = torch.Generator(device=cuda).manual_seed(n + len(flags))
    if flags == "none":
        f = None
    elif flags == "p01":
        f = torch.rand(n, generator=g, device=cuda) < 0.01
    elif flags == "every1000":
        f = torch.arange(n, device=cuda) % 1000 == 0
    else:
        f = torch.ones(n, dtype=torch.bool, device=cuda)
    for ops in (("min",), ("min", "min"), ("sum", "min", "max"), ("max", "sum", "min", "sum")):
        lanes = _scan_lanes(cuda, g, n, dtype, ops)
        got = segment.segment_scan_cuda(lanes, f, ops, reverse)
        want = segment._plain_multi_scan(lanes, f, ops, reverse)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (ops, flags, reverse)


@pytest.mark.cuda
def test_segment_scan_dispatch_checks_and_counts(cuda):
    v = torch.arange(10, device=cuda, dtype=torch.int16)
    before = segment.segment_scan_cuda.launches
    (out,) = segment.segment_multi_scan([v], None)
    assert segment.segment_scan_cuda.launches == before + 1 and out.dtype == torch.int16
    assert torch.equal(out, torch.cumsum(v, 0, dtype=torch.int16))
    with pytest.raises(TypeError):
        segment.segment_scan_cuda([v], None, ("sum",))
    with pytest.raises(ValueError):
        segment.segment_scan_cuda([v.int()] * 5, None, ("sum",) * 5)
    with pytest.raises(ValueError):
        segment.segment_scan_cuda([v.int()[::2]], None, ("sum",))
    assert segment.segment_scan_cuda.launches == before + 1
