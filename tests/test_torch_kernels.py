"""The hand-written CUDA kernels against their plain PyTorch versions, on the card
(the histogram, the segmented scan and its uses, Kendall's merge-count chain).

Every test here needs a CUDA card and nvcc (the kernels have no CPU mode): each is
marked ``cuda`` and skips elsewhere. The file imports neither JAX nor metrics_tpu,
so that it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py
"""
import pytest
import torch

from metrics_tpu_torch.ops import histogram, segment
from tests.torch_deadline import deadline  # noqa: F401


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


# ---- the single-pass scan's edges: tile sizes, ragged reverse tiles, views, races

_SCAN_OPS = (("min",), ("min", "min"), ("sum", "min", "max"), ("max", "sum", "min", "sum"))


def _scan_flags(cuda, g, kind, n):
    if kind == "none":
        return None
    if kind == "p01":
        return torch.rand(n, generator=g, device=cuda) < 0.01
    return torch.arange(n, device=cuda) % 1000 == 0


def _assert_scan_matches(lanes, f, ops, reverse):
    got = segment.segment_scan_cuda(lanes, f, ops, reverse)
    want = segment._plain_multi_scan(lanes, f, ops, reverse)
    for lane, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), (lane, ops, reverse, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("flags", ["none", "p01"])
@pytest.mark.parametrize("ops", _SCAN_OPS, ids=len)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_segment_scan_tile_edges_on_card(cuda, dtype, ops, flags, reverse):
    tile = segment.segment_scan_cuda.tile_rows(len(ops), dtype)
    # T-1, T, T+1, 2T+1, and ragged tails with n % 4 of 1, 2 and 3
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1, 3 * tile + 2, 3 * tile + 3):
        g = torch.Generator(device=cuda).manual_seed(n)
        lanes = _scan_lanes(cuda, g, n, dtype, ops)
        _assert_scan_matches(lanes, _scan_flags(cuda, g, flags, n), ops, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_segment_scan_misaligned_views_on_card(cuda, dtype, reverse):
    ops = ("sum", "min", "max")
    n = 5 * segment.segment_scan_cuda.tile_rows(len(ops), dtype) + 7
    g = torch.Generator(device=cuda).manual_seed(7)
    # views one element in (4 or 8 bytes): contiguous, not 16-byte aligned
    lanes = [buf[1:] for buf in _scan_lanes(cuda, g, n + 1, dtype, ops)]
    flag_buf = torch.rand(n + 4, generator=g, device=cuda) < 0.01
    for f in (None, flag_buf[4:], flag_buf[1:n + 1]):
        _assert_scan_matches(lanes, f, ops, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["none", "every1000"])
def test_segment_scan_back_to_back_launches_on_card(cuda, flags):
    """20 launches in a row at N = 2^26 + 3, four int64 lanes: each bit-equal."""
    n, ops = (1 << 26) + 3, ("max", "sum", "min", "sum")
    g = torch.Generator(device=cuda).manual_seed(26)
    lanes = _scan_lanes(cuda, g, n, torch.int64, ops)
    f = _scan_flags(cuda, g, flags, n)
    want = segment._plain_multi_scan(lanes, f, ops, True)
    bad = torch.zeros((), dtype=torch.bool, device=cuda)
    for _ in range(20):
        for a, b in zip(segment.segment_scan_cuda(lanes, f, ops, True), want):
            bad |= (a != b).any()
    assert not bool(bad)


# ---- the run-merging histogram: coherent runs, one hot bin, views


def _assert_histogram_matches(ids, mask, w, bins):
    for weights in (None, mask):
        assert torch.equal(histogram.histogram_cuda(ids, weights, bins), histogram._plain_bincount(ids, weights, bins))
    got = histogram.histogram_cuda(ids, w, bins).double()
    want = histogram._plain_bincount(ids, w.double(), bins)
    scale = histogram._plain_bincount(ids, w.abs().double(), bins)
    assert bool(torch.all((got - want).abs() <= 1e-5 * scale))  # atomics add in no fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [1, 25, 361, 16384])
def test_kernel_coherent_runs_on_card(cuda, bins):
    """Runs of 1 to 4,096 equal ids, with dropped ids and masked rows inside runs."""
    g = torch.Generator(device=cuda).manual_seed(bins)
    lengths = torch.randint(1, 4097, (2000,), generator=g, device=cuda)
    values = torch.randint(-3, bins + 3, (2000,), generator=g, device=cuda, dtype=torch.int32)
    ids = torch.repeat_interleave(values, lengths)
    n = ids.numel()
    mask = torch.rand(n, generator=g, device=cuda) < 0.9
    _assert_histogram_matches(ids, mask, torch.randn(n, generator=g, device=cuda), bins)


@pytest.mark.cuda
def test_kernel_one_hot_bin_on_card(cuda):
    n = (1 << 24) + 17
    ids = torch.full((n,), 5, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    mask[::3] = False
    got = histogram.histogram_cuda(ids, None, 25)
    assert int(got[5]) == n and int(got.sum()) == n
    assert int(histogram.histogram_cuda(ids, mask, 25)[5]) == n - (n + 2) // 3


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_misaligned_views_on_card(cuda, offset):
    bins, n = 361, (1 << 20) + 5
    g = torch.Generator(device=cuda).manual_seed(offset)
    ids = torch.randint(-3, bins + 3, (n + offset,), generator=g, device=cuda, dtype=torch.int32)[offset:]
    mask = (torch.rand(n + offset, generator=g, device=cuda) < 0.7)[offset:]
    w = torch.randn(n + offset, generator=g, device=cuda)[offset:]
    _assert_histogram_matches(ids, mask, w, bins)


@pytest.mark.cuda
def test_kernel_bin_counts_above_48kb_in_turn_on_card(cuda):
    """Bin counts that need more than 48 KB of shared memory, alternating: a smaller
    one after a larger one must not leave the larger one's launch above the limit."""
    g = torch.Generator(device=cuda).manual_seed(48)
    for bins in (16384, 13000, 16384, 13000):
        ids = torch.randint(-3, bins + 3, ((1 << 20) + 3,), generator=g, device=cuda, dtype=torch.int32)
        mask = torch.rand(ids.numel(), generator=g, device=cuda) < 0.7
        _assert_histogram_matches(ids, mask, torch.randn(ids.numel(), generator=g, device=cuda), bins)


# ---- the retrieval path's lane sets, with real segment flags


class _RecordingScan:
    """Stands in for ``segment.segment_scan_cuda``: launches the kernel, keeps each call."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, []

    def __call__(self, values, flags, ops, reverse=False):
        outs = self.kernel(values, flags, ops, reverse)
        self.calls.append((tuple(values), flags, tuple(ops), reverse, outs))
        return outs


def _retrieval_rows(cuda, shape):
    """Shuffled rows of a retrieval run on the card: 6,980 queries of 1,000 candidates,
    or 60 queries of 1 to 300 rows; bf16-rounded scores, sparse relevance."""
    g = torch.Generator(device=cuda).manual_seed(6980)
    if shape == "msmarco":
        sizes = torch.full((6980,), 1000, device=cuda)
    else:
        sizes = torch.randint(1, 301, (60,), generator=g, device=cuda)
    indexes = torch.repeat_interleave(torch.arange(sizes.numel(), device=cuda, dtype=torch.int32), sizes)
    n = indexes.numel()
    target = (torch.rand(n, generator=g, device=cuda) < 0.002).to(torch.int32)
    preds = (torch.randn(n, generator=g, device=cuda) + 1.5 * target).to(torch.bfloat16).to(torch.float32)
    perm = torch.randperm(n, generator=g, device=cuda)
    return indexes[perm], preds[perm], target[perm]


# metric, top_k -> the lane sets of its scan calls, in order
_RETRIEVAL_LANE_SETS = {
    ("average_precision", None): [(("sum", "sum"), False)],
    ("reciprocal_rank", None): [(("sum", "sum", "min"), False)],
    ("precision", 10): [(("sum", "sum"), False), (("sum",), False)],
    ("r_precision", None): [(("sum", "sum"), False), (("sum",), True), (("sum",), False)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["msmarco", "ragged"])
@pytest.mark.parametrize("metric,top_k", list(_RETRIEVAL_LANE_SETS), ids=lambda v: str(v))
def test_retrieval_lane_sets_on_card(cuda, monkeypatch, metric, top_k, shape):
    """Pass A with 2 and 3 lanes, pass B, the reverse pass over segment-last flags and
    the gated pass, as the retrieval compute issues them: each launch bit-equal to
    the plain version on the same lanes and flags."""
    recorder = _RecordingScan(segment.segment_scan_cuda)
    monkeypatch.setattr(segment, "segment_scan_cuda", recorder)
    indexes, preds, target = _retrieval_rows(cuda, shape)
    scores, n_pos, valid = segment.grouped_retrieval_scores(indexes, preds, target, metric, top_k=top_k)
    assert [(ops, reverse) for _, _, ops, reverse, _ in recorder.calls] == _RETRIEVAL_LANE_SETS[(metric, top_k)]
    for lanes, flags, ops, reverse, outs in recorder.calls:
        assert flags is not None and flags.dtype == torch.bool and all(v.dtype == torch.int32 for v in lanes)
        for a, b in zip(outs, segment._plain_multi_scan(lanes, flags, ops, reverse)):
            assert torch.equal(a, b), (metric, ops, reverse, int((a != b).sum()))
    assert int(valid.sum()) == int(torch.unique(indexes).numel()) and bool(torch.isfinite(scores).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 22) + 5])
def test_kernel_calibration_modes_on_card(cuda, n):
    """The calibration error's three launches: 16 bins (15 and the bin of confidences of
    exactly 1.0), a mask of correct samples, and float32 confidence sums."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries

    g = torch.Generator(device=cuda).manual_seed(n)
    conf = torch.rand(n, generator=g, device=cuda)
    conf[:7] = 1.0
    ids = (torch.searchsorted(_bin_boundaries(15, cuda), conf, right=True) - 1).clamp(0, 15).to(torch.int32)
    ids[::97] = -1  # masked samples drop
    correct = torch.rand(n, generator=g, device=cuda) < conf
    assert torch.equal(histogram.histogram_cuda(ids, None, 16), histogram._plain_bincount(ids, None, 16))
    assert torch.equal(histogram.histogram_cuda(ids, correct, 16), histogram._plain_bincount(ids, correct, 16))
    got = histogram.histogram_cuda(ids, conf, 16).double()
    want = histogram._plain_bincount(ids, conf.double(), 16)
    assert bool(torch.all((got - want).abs() <= 1e-5 * want.abs()))


@pytest.mark.cuda
def test_calibration_and_fairness_on_card_match_cpu(cuda):
    from metrics_tpu_torch.classification import BinaryCalibrationError, BinaryFairness

    g = torch.Generator(device=cuda).manual_seed(6)
    preds = torch.rand(100_000, generator=g, device=cuda)
    target = (torch.rand(100_000, generator=g, device=cuda) < preds).long()
    groups = torch.randint(0, 7, (100_000,), generator=g, device=cuda)
    before = histogram.histogram_cuda.launches
    for norm in ("l1", "l2", "max"):
        card, cpu = BinaryCalibrationError(norm=norm), BinaryCalibrationError(norm=norm, device="cpu")
        card.update(preds, target)
        cpu.update(preds.cpu(), target.cpu())
        assert abs(card.compute().item() - cpu.compute().item()) <= 1e-6
    fair, fair_cpu = BinaryFairness(7), BinaryFairness(7, device="cpu")
    fair.update(preds, target, groups)
    fair_cpu.update(preds.cpu(), target.cpu(), groups.cpu())
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(fair, name).cpu(), getattr(fair_cpu, name))
    assert histogram.histogram_cuda.launches == before + 3 * 3 + 1


# ------------------------------------------------------------- Kendall's pair counts


def _kendall_columns(cuda, g, n, c, kind):
    if kind == "continuous":
        x = torch.randn(n, c, generator=g, device=cuda)
        y = x + 0.5 * torch.randn(n, c, generator=g, device=cuda)
    else:  # ties, signed zeros, infinities and NaNs
        x = torch.randint(-3, 4, (n, c), generator=g, device=cuda).float()
        y = torch.randint(-2, 3, (n, c), generator=g, device=cuda).float()
        pick = torch.rand(n, c, generator=g, device=cuda)
        x = torch.where(pick < 0.02, float("nan"), torch.where(pick > 0.97, float("inf"), x))
        y = torch.where(pick > 0.99, float("-inf"), torch.where((pick > 0.5) & (pick < 0.52), -0.0, y))
    return x, y


KENDALL_SHAPES = [(1, 1), (2, 1), (1023, 1), (1024, 2), (1025, 3), (4095, 1), (4096, 2), (4097, 3), (5000, 12),
                  (8193, 2), (10_831, 12), (131_072, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["continuous", "special"])
@pytest.mark.parametrize("n,c", KENDALL_SHAPES)
def test_kendall_pairs_matches_plain_on_card(cuda, n, c, kind):
    """The chain equals both plain versions: one call, its merge passes."""
    from metrics_tpu_torch.ops import kendall

    g = torch.Generator(device=cuda).manual_seed(n + c)
    x, y = _kendall_columns(cuda, g, n, c, kind)
    wrapper = kendall.kendall_pairs_cuda
    before = (wrapper.launches, wrapper.kernel_launches)
    got = kendall.pair_counts(x, y)
    assert (wrapper.launches, wrapper.kernel_launches) == (
        before[0] + 1, before[1] + 4 + kendall.KendallPairsKernel.merge_passes(n))
    assert got.dtype == torch.int64 and torch.equal(got, kendall._plain_pair_counts(x, y))
    assert torch.equal(got, kendall._plain_merge_pair_counts(x, y))


@pytest.mark.cuda
def test_kendall_pairs_of_ragged_columns_on_card(cuda):
    """Columns whose R (rows without a NaN) ends at different lengths, some of them empty."""
    from metrics_tpu_torch.ops import kendall

    g = torch.Generator(device=cuda).manual_seed(7)
    n, c = 3 * kendall.MERGE_TILE + 5, 6
    x = torch.randint(0, 50, (n, c), generator=g, device=cuda).float()
    y = torch.randint(0, 50, (n, c), generator=g, device=cuda).float()
    for col, keep in enumerate((n, n - 1, kendall.MERGE_TILE, kendall.MERGE_TILE + 1, 1, 0)):
        x[keep:, col] = float("nan") if col % 2 else x[keep:, col]
        y[keep:, col] = y[keep:, col] if col % 2 else float("nan")
    got = kendall.kendall_pairs_cuda(x, y)
    assert torch.equal(got, kendall._plain_pair_counts(x, y))
    assert torch.equal(got, kendall._plain_merge_pair_counts(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131_072, 1 << 24])
def test_kendall_pairs_closed_form_past_2_to_the_31_on_card(cuda, n):
    """preds = target = arange(n): every pair concordant, N (N - 1) / 2 of them; -target:
    every pair discordant."""
    from metrics_tpu_torch.ops import kendall

    ramp = torch.arange(n, device=cuda, dtype=torch.float32)
    both = n * (n - 1) // 2
    assert kendall.kendall_pairs_cuda(ramp, ramp).tolist() == [[both, 0, 0, 0]] and both > 1 << 31
    assert kendall.kendall_pairs_cuda(ramp, -ramp).tolist() == [[0, both, 0, 0]]


@pytest.mark.cuda
def test_kendall_pairs_wrapper_checks(cuda):
    from metrics_tpu_torch.ops import kendall

    x = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError):
        kendall.kendall_pairs_cuda(x.cpu(), x.cpu())
    with pytest.raises(ValueError):
        kendall.kendall_pairs_cuda(x, x[:9])
    with pytest.raises(ValueError):
        kendall.kendall_pairs_cuda(torch.zeros(2, kendall.MAX_COLUMNS + 1, device=cuda),
                                   torch.zeros(2, kendall.MAX_COLUMNS + 1, device=cuda))
    assert kendall.kendall_pairs_cuda(torch.zeros(5, 0, device=cuda), torch.zeros(5, 0, device=cuda)).shape == (0, 4)
    empty = torch.zeros(0, 3, device=cuda)
    assert kendall.kendall_pairs_cuda(empty, empty).tolist() == [[0, 0, 0, 0]] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(7, 1), (10_831, 24), ((1 << 20) + 3, 2)])
def test_average_ranks_on_card_match_cpu(cuda, n, c):
    """Spearman's tie-run ranks: two scan launches on the card, equal to the CPU's plain scans."""
    from metrics_tpu_torch.ops.rank import average_ranks

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, max(2, n // 50), (n, c), generator=g, device=cuda).float()
    x[::13] = -0.0
    x[5::101] = float("nan")
    before = segment.segment_scan_cuda.launches
    got = average_ranks(x)
    assert segment.segment_scan_cuda.launches == before + 2
    assert torch.equal(got.cpu(), average_ranks(x.cpu()))


# ------------------------------------------------------------ nominal pair counts

PAIR_SETS = {  # column cardinalities: one pair, UCI Adult's 28 pairs (3,982 bins), past 2^14 bins
    "one_pair": ((9, 16), 1),
    "adult_28_pairs": ((9, 16, 7, 15, 6, 5, 2, 42), 1),
    "past_2_14_bins": ((200, 150, 3, 90), 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAIR_SETS))
def test_pair_confusion_counts_on_card_match_per_pair_plain_counts(cuda, case):
    """Every column pair counted in the histogram kernel's count mode (one launch while
    the bins total at most 2^14), each table equal to the plain count of its pair."""
    import itertools

    from metrics_tpu_torch.ops.confmat import pair_confusion_counts

    cards, launches = PAIR_SETS[case]
    g = torch.Generator(device=cuda).manual_seed(len(cards))
    n = 48_842
    cols = torch.stack([torch.randint(0, c, (n,), generator=g, device=cuda) for c in cards], 1)
    valid = torch.rand(n, len(cards), generator=g, device=cuda) > 0.01
    pairs = list(itertools.combinations(range(len(cards)), 2))
    before = histogram.histogram_cuda.launches
    tables = pair_confusion_counts(cols, pairs, cards, valid)
    assert histogram.histogram_cuda.launches == before + launches
    for p, (i, j) in enumerate(pairs):
        ids = torch.where(valid[:, i] & valid[:, j], cols[:, j] * cards[i] + cols[:, i], -1)
        want = histogram._plain_bincount(ids, None, cards[i] * cards[j]).long().reshape(cards[j], cards[i])
        assert torch.equal(tables[p, : cards[j], : cards[i]], want), (i, j)
        assert int(tables[p].sum()) == int(want.sum())


# ------------------------------------------------- the batched mode and the engines

BATCHED_SHAPES = [(10_000, 1, 100), (16, 65_536, 4), (100, 256, 1_000_000), (3, 0, 5), (7, 33, 1), (5, 1_000, 8_192)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,bins", BATCHED_SHAPES)
def test_batched_kernel_matches_plain_on_card(cuda, rows, k, bins):
    g = torch.Generator(device=cuda).manual_seed(rows + k + bins)
    ids = torch.randint(-2, bins + 2, (rows, k), generator=g, device=cuda, dtype=torch.int32)
    ids[0] = -1  # an empty row
    mask = torch.rand((rows, k), generator=g, device=cuda) < 0.7
    # quarter steps: every order of the float atomics gives the same sums
    w = torch.randint(-8, 8, (rows, k), generator=g, device=cuda).float() / 4
    for weights in (None, mask, w):
        got = histogram.histogram_batched_cuda(ids, weights, bins)
        assert torch.equal(got, histogram._plain_batched_bincount(ids, weights, bins))
    noisy = torch.randn((rows, k), generator=g, device=cuda)
    got = histogram.histogram_batched_cuda(ids, noisy, bins).double()
    want = histogram._plain_batched_bincount(ids, noisy.double(), bins)
    scale = histogram._plain_batched_bincount(ids, noisy.abs().double(), bins)
    assert bool(torch.all((got - want).abs() <= 1e-5 * scale))


@pytest.mark.cuda
def test_vmap_rule_launches_the_batched_kernel(cuda):
    ids = torch.randint(0, 12, (64, 3), device=cuda)
    before = (histogram.histogram_batched_cuda.launches, histogram.histogram_cuda.launches)
    out = torch.func.vmap(lambda r: histogram.bincount(r, 10))(ids)
    assert (histogram.histogram_batched_cuda.launches, histogram.histogram_cuda.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(out, histogram._plain_batched_bincount(ids, None, 10))
    with pytest.raises(ValueError):
        histogram.histogram_batched_cuda(ids.long(), None, 10)
    with pytest.raises(TypeError):
        histogram.histogram_batched_cuda(ids.int(), torch.ones(64, 3, device=cuda, dtype=torch.float64), 10)


@pytest.mark.cuda
def test_fused_collection_replays_and_matches_eager_on_card(cuda):
    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection, engine_for

    g = torch.Generator(device=cuda).manual_seed(0)
    fused, eager = canonical_collection(True), canonical_collection(False)
    for _ in range(4):
        p = torch.rand(4096, generator=g, device=cuda)
        t = torch.randint(0, 2, (4096,), generator=g, device=cuda, dtype=torch.int32)
        fused.update(p, t)
        eager.update(p, t)
    got, want = fused.compute(), eager.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    stats = engine_for(fused).stats
    assert (stats["launches"], stats["cache_misses"], stats["degrades"], stats["fallback_groups"]) == (4, 1, 0, 0)
    leader = fused._modules["BinaryAccuracy"]
    assert all(isinstance(step, CapturedStep) for step in engine_for(fused)._steps.steps.values())
    fused.reset()  # the live state leaves its static buffer: copied in at the next replay
    eager.reset()
    fused.update(p, t)
    eager.update(p, t)
    assert torch.equal(fused.compute()["BinaryConfusionMatrix"], eager.compute()["BinaryConfusionMatrix"])
    assert leader.tp.device.type == "cuda"


@pytest.mark.cuda
def test_host_read_in_an_update_demotes_only_its_group_on_card(cuda):
    import warnings

    from metrics_tpu_torch.classification import BinaryAccuracy
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.core.fused import engine_for
    from metrics_tpu_torch.regression import MeanSquaredError

    class HostRead(MeanSquaredError):
        def update(self, preds, target):
            if float(preds.sum()) > -1:  # a host read: a capture cannot take it
                super().update(preds, target)

    coll = MetricCollection({"acc": BinaryAccuracy(), "bad": HostRead()}, fused=True)
    p = torch.rand(256, device=cuda)
    t = torch.randint(0, 2, (256,), device=cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        coll.update(p, t)
        coll.update(p, t)
    assert any("cannot fuse" in str(w.message) for w in caught)
    eng = engine_for(coll)
    assert eng.stats["launches"] == 2 and "bad" in eng._trace_fallbacks and eng.stats["degrades"] == 0


@pytest.mark.cuda
def test_fleet_routed_update_replays_on_card(cuda):
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import fleet

    g = torch.Generator(device=cuda).manual_seed(1)
    metric = MulticlassAccuracy(num_classes=10, average=None, fleet_size=16)
    refs = [MulticlassAccuracy(num_classes=10, average=None) for _ in range(16)]
    for _ in range(3):
        p = torch.randint(0, 10, (2000,), generator=g, device=cuda)
        t = torch.randint(0, 10, (2000,), generator=g, device=cuda)
        ids = torch.randint(0, 15, (2000,), generator=g, device=cuda)
        metric.update(p, t, stream_ids=ids)
        for s in range(15):
            refs[s].update(p[ids == s], t[ids == s])
    out = metric.compute()
    assert all(torch.equal(out[s], refs[s].compute()) for s in range(15))
    assert len(fleet._steps_for(metric).steps) == 1
    assert fleet.step_stats(metric)["launches"] == 3 and fleet.step_stats(metric)["degrades"] == 0
    assert torch.equal(metric.tp[15], torch.zeros_like(metric.tp[15]))


@pytest.mark.cuda
def test_replays_count_the_launches_their_capture_recorded(cuda):
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.core.fused import canonical_collection

    g = torch.Generator(device=cuda).manual_seed(3)
    p = torch.rand(4096, generator=g, device=cuda)
    t = torch.randint(0, 2, (4096,), generator=g, device=cuda, dtype=torch.int32)
    eager = canonical_collection(False)
    before = histogram.histogram_cuda.launches
    eager.update(p, t)
    per_step = histogram.histogram_cuda.launches - before
    fused = canonical_collection(True)
    before = histogram.histogram_cuda.launches
    for _ in range(5):
        fused.update(p, t)
    # the warm-up's launches ran; the capture's were only recorded; each of 5 replays ran them
    assert per_step >= 1 and histogram.histogram_cuda.launches - before == 6 * per_step
    metric = MulticlassAccuracy(num_classes=10, average=None, fleet_size=16)
    x = torch.randint(0, 10, (2000,), generator=g, device=cuda)
    ids = torch.randint(0, 16, (2000,), generator=g, device=cuda)
    before = histogram.histogram_batched_cuda.launches
    for _ in range(4):
        metric.update(x, x, stream_ids=ids)
    assert histogram.histogram_batched_cuda.launches - before == 5
    assert fleet.step_stats(metric)["launches"] == 4


@pytest.mark.cuda
def test_fused_forward_matches_eager_on_card(cuda):
    import warnings

    from metrics_tpu_torch.core.fused import canonical_collection, engine_for

    g = torch.Generator(device=cuda).manual_seed(2)
    fused, eager = canonical_collection(True), canonical_collection(False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            p = torch.rand(4096, generator=g, device=cuda)
            t = torch.randint(0, 2, (4096,), generator=g, device=cuda, dtype=torch.int32)
            got, want = fused(p, t), eager(p, t)
            for k in want:  # batch values computed inside the graph
                assert torch.allclose(got[k].double(), want[k].double(), rtol=1e-6, atol=1e-7)
    assert not [w for w in caught if "cannot fuse" in str(w.message) or "degraded" in str(w.message)]
    assert engine_for(fused).stats["launches"] == 3 and engine_for(fused).stats["fallback_groups"] == 0
    got, want = fused.compute(), eager.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_vmap_rule_is_one_launch_on_card(cuda, reverse):
    g = torch.Generator(device=cuda).manual_seed(7 + reverse)
    lanes = [torch.randint(-9, 9, (6, 5000), generator=g, device=cuda, dtype=torch.int32) for _ in range(3)]
    flags = torch.rand((6, 5000), generator=g, device=cuda) < 0.01
    ops = ("sum", "min", "max")
    before = segment.segment_scan_cuda.launches
    got = torch.func.vmap(lambda f, *ls: segment.segment_multi_scan(ls, f, ops=ops, reverse=reverse))(flags, *lanes)
    assert segment.segment_scan_cuda.launches - before == 1
    for i in range(6):
        want = segment._plain_multi_scan([lane[i] for lane in lanes], flags[i], ops, reverse)
        assert all(torch.equal(a[i], b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_padded_curves_on_card_equal_the_cpu(cuda):
    from metrics_tpu_torch.ops import clf_curve

    g = torch.Generator(device=cuda).manual_seed(5)
    preds = torch.round(torch.rand((4, 3000), generator=g, device=cuda) * 100) / 100
    target = torch.randint(-1, 2, (4, 3000), generator=g, device=cuda)
    for curve in (clf_curve.binary_precision_recall_curve_padded, clf_curve.binary_roc_curve_padded):
        before = segment.segment_scan_cuda.launches
        got = torch.func.vmap(curve)(preds, target)
        assert segment.segment_scan_cuda.launches - before == 1  # one scan for the stack
        for i in range(4):
            want = curve(preds[i].cpu(), target[i].cpu())
            assert all(torch.equal(a[i].cpu(), b) or torch.allclose(a[i].cpu(), b, equal_nan=True, rtol=0, atol=0)
                       for a, b in zip(got, want))


@pytest.mark.cuda
def test_stacked_bootstrapper_is_one_replay_on_card(cuda):
    import numpy as np

    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.wrappers import BootStrapper

    g = torch.Generator(device=cuda).manual_seed(11)
    boot = BootStrapper(MulticlassAccuracy(10, average="macro"), 8, seed=3, raw=True)
    bases = [MulticlassAccuracy(10, average="macro") for _ in range(8)]
    rng = np.random.default_rng(3)
    before = histogram.histogram_batched_cuda.launches
    for _ in range(4):
        p = torch.randint(0, 10, (512,), generator=g, device=cuda)
        t = torch.randint(0, 10, (512,), generator=g, device=cuda)
        boot.update(p, t)
        idx = boot._indices(boot._device_draws(int(rng.integers(0, 2**63 - 1)), 512), 512)
        for base, rows in zip(bases, idx):
            base.update(p[rows], t[rows])
    assert histogram.histogram_batched_cuda.launches - before == 5  # warm-up + 4 replays
    assert fleet.step_stats(boot)["launches"] == 4 and fleet.step_stats(boot)["degrades"] == 0
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(boot, f"boot_{name}"), torch.stack([getattr(b, name) for b in bases]))
    assert torch.equal(boot.compute()["raw"], torch.stack([b.compute() for b in bases]))


@pytest.mark.cuda
def test_minmax_fleet_updates_its_base_once_per_batch_on_card(cuda):
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import MinMaxMetric

    g = torch.Generator(device=cuda).manual_seed(13)
    wrapper = MinMaxMetric(MulticlassAccuracy(3), fleet_size=2)
    base, values = MulticlassAccuracy(3), []
    for _ in range(4):
        p, t = (torch.randint(0, 3, (64,), generator=g, device=cuda) for _ in range(2))
        wrapper.update(p, t)
        base.update(p, t)
        out, want = wrapper.compute(), base.compute()
        values.append(want)
        assert torch.equal(out["raw"], want.expand(2))
        assert torch.equal(out["max"], torch.stack(values).max().expand(2))
        assert torch.equal(out["min"], torch.stack(values).min().expand(2))
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(wrapper._base_metric, name), getattr(base, name))


@pytest.mark.cuda
def test_forward_keeps_the_state_a_replay_left_on_card(cuda):
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.wrappers import BootStrapper

    g = torch.Generator(device=cuda).manual_seed(17)
    batches = [tuple(torch.randint(0, k, (256,), generator=g, device=cuda) for k in (5, 5, 2)) for _ in range(3)]
    routed = MulticlassAccuracy(5, average=None, fleet_size=2)
    twin = MulticlassAccuracy(5, average=None, fleet_size=2)
    boot = BootStrapper(MulticlassAccuracy(5, average="macro"), 4, seed=2)
    for p, t, i in batches:
        routed(p, t, stream_ids=i)
        twin.update(p, t, stream_ids=i)
        boot(p, t)
    assert fleet.step_stats(routed)["launches"] >= 3 and fleet.step_stats(boot)["launches"] >= 3
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(routed, name), getattr(twin, name))
    # every copy's resample of a batch has its 256 rows: the forwards' batches all stayed
    assert torch.equal((boot.boot_tp + boot.boot_fn).sum(-1), torch.full((4,), 3 * 256, device=cuda))


@pytest.mark.cuda
def test_fleet_bootstrapper_draws_once_for_every_stream_on_card(cuda):
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.wrappers import BootStrapper

    g = torch.Generator(device=cuda).manual_seed(19)
    boot = BootStrapper(MulticlassAccuracy(5, average="macro"), 4, fleet_size=3, seed=1)
    for _ in range(2):
        p, t = (torch.randint(0, 5, (128,), generator=g, device=cuda) for _ in range(2))
        boot.update(p, t)
    assert torch.equal(boot.boot_tp[0], boot.boot_tp[1]) and torch.equal(boot.boot_tp[0], boot.boot_tp[2])
    ids = torch.randint(0, 3, (128,), generator=g, device=cuda)
    boot.update(p, t, stream_ids=ids)
    rows = 2 * 128 + torch.bincount(ids, minlength=3)
    # every copy of a stream holds each of its rows' resamples: 128 a broadcast batch, 1 a routed row
    assert torch.equal((boot.boot_tp + boot.boot_fn).sum(-1), rows.unsqueeze(-1).expand(3, 4))
    assert fleet.step_stats(boot)["launches"] == 0  # eager: the draws stay out of graphs
    assert boot.compute()["mean"].shape == (3,)


# ------------------------------------------------ the sketch family and the tolerance tier


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [11, 14])
def test_sketch_bucket_counts_take_the_mask_mode_on_card(cuda, bits):
    from metrics_tpu_torch.ops import rank

    g = torch.Generator(device=cuda).manual_seed(bits)
    scores = torch.sigmoid(torch.randn(65_536, generator=g, device=cuda)).to(torch.bfloat16).float()
    target = (torch.rand(65_536, generator=g, device=cuda) < 0.03).long()
    valid = torch.rand(65_536, generator=g, device=cuda) < 0.9
    keys = rank.monotone_key_descending(scores, valid)
    before = histogram.histogram_cuda.launches
    pos, neg = rank.class_bucket_counts(keys, target == 1, valid, bits)
    assert histogram.histogram_cuda.launches == before + 2
    ids = (keys >> (32 - bits)).to(torch.int32)
    assert torch.equal(pos, histogram._plain_bincount(ids, (target == 1) & valid, 1 << bits))
    assert torch.equal(pos + neg, histogram._plain_bincount(ids, valid, 1 << bits))


@pytest.mark.cuda
def test_one_vs_rest_sketch_update_is_two_batched_launches_on_card(cuda):
    from metrics_tpu_torch.classification import MulticlassAUROC, MultilabelAveragePrecision
    from metrics_tpu_torch.ops import rank

    g = torch.Generator(device=cuda).manual_seed(3)
    preds = torch.softmax(2.0 * torch.randn((256, 1000), generator=g, device=cuda), dim=1)
    target = torch.randint(0, 1000, (256,), generator=g, device=cuda)
    metric = MulticlassAUROC(1000, average=None, tolerance=1e-2)
    before = (histogram.histogram_batched_cuda.launches, histogram.histogram_cuda.launches)
    metric.update(preds, target)
    assert (histogram.histogram_batched_cuda.launches, histogram.histogram_cuda.launches) == (
        before[0] + 2, before[1])
    lanes = [rank.hist_class_counts(preds[:, c], target == c, target >= 0, 12) for c in range(1000)]
    assert torch.equal(metric.pos_hist, torch.stack([p for p, _ in lanes]))
    assert torch.equal(metric.neg_hist, torch.stack([n for _, n in lanes]))
    ml_preds = torch.rand((512, 7), generator=g, device=cuda)
    ml_target = torch.randint(-1, 2, (512, 7), generator=g, device=cuda)
    ml = MultilabelAveragePrecision(7, average=None, tolerance=1e-2, ignore_index=-1)
    ml_cpu = MultilabelAveragePrecision(7, average=None, tolerance=1e-2, ignore_index=-1, device="cpu")
    ml.update(ml_preds, ml_target)
    ml_cpu.update(ml_preds.cpu(), ml_target.cpu())
    assert torch.equal(ml.pos_hist.cpu(), ml_cpu.pos_hist) and torch.equal(ml.neg_hist.cpu(), ml_cpu.neg_hist)


@pytest.mark.cuda
def test_distinct_count_uint8_scatter_max_on_card(cuda):
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.core.collections import MetricCollection
    from metrics_tpu_torch.core.fused import engine_for
    from metrics_tpu_torch.sketches import DistinctCount

    g = torch.Generator(device=cuda).manual_seed(5)
    batches = [torch.randint(0, 40_000_000, (65_536,), generator=g, device=cuda) for _ in range(3)]
    card, cpu = DistinctCount(p=14), DistinctCount(p=14, device="cpu")
    fused = MetricCollection({"dc": DistinctCount(p=14)}, fused=True)
    for ids in batches:
        card.update(ids)
        cpu.update(ids.cpu())
        fused.update(ids)
    assert card.registers.dtype == torch.uint8
    assert torch.equal(card.registers.cpu(), cpu.registers)
    assert torch.equal(fused["dc"].registers.cpu(), cpu.registers)
    assert engine_for(fused).stats["launches"] == 3 and engine_for(fused).stats["degrades"] == 0
    streams = DistinctCount(p=12, fleet_size=4)
    apart = [DistinctCount(p=12) for _ in range(4)]
    for ids in batches:
        rows = ids[:10_000]
        sid = torch.randint(0, 4, (10_000,), generator=g, device=cuda)
        streams.update(rows, stream_ids=sid)
        for s in range(4):
            apart[s].update(rows[sid == s])
    assert fleet.step_stats(streams)["degrades"] == 0
    assert all(torch.equal(streams.registers[s], apart[s].registers) for s in range(4))


@pytest.mark.cuda
def test_ingest_tick_thread_replays_while_the_main_thread_enqueues_on_card(cuda):
    """The tick thread captures and replays the chained step (thread-local capture)
    while this thread keeps enqueueing batches it draws on the card; after ``flush``
    the state is bit-equal to synchronous fused updates, with no degrade."""
    import threading

    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection
    from metrics_tpu_torch.serve import IngestQueue

    g = torch.Generator(device=cuda).manual_seed(11)
    batches = [(torch.rand(8192, generator=g, device=cuda),
                torch.randint(0, 2, (8192,), generator=g, device=cuda, dtype=torch.int32)) for _ in range(64)]
    sync = canonical_collection(True)
    for p, t in batches:
        sync.update(p, t)
    target = canonical_collection(True)
    side = torch.cuda.Stream()
    with IngestQueue(target, capacity=16, tick_interval_s=0.0005, max_coalesce=8) as q:
        for i, (p, t) in enumerate(batches):
            with torch.cuda.stream(side):  # the producer's own stream: the tick waits on its event
                p2, t2 = p * 1.0, t + 0
                q.enqueue(p2, t2)
            if i % 16 == 15:
                threading.Event().wait(0.002)
        q.flush()
        assert q.stats["degrades"] == 0 and q.stats["launches"] >= 8 and q.stats["eager_entries"] == 0
        assert all(isinstance(s, CapturedStep) for s in q._steps.steps.values())
        stats = dict(q.stats)
    got, want = target.compute(), sync.compute()
    diff = {k: (got[k].tolist(), want[k].tolist()) for k in want if not torch.equal(got[k], want[k])}
    assert not diff, f"ticked values differ from the synchronous run: {diff}; queue stats {stats}"


@pytest.mark.cuda
def test_fleet_compile_fault_runs_the_key_eagerly_on_card(cuda):
    import warnings

    from metrics_tpu_torch import fault
    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.regression import MeanSquaredError

    # whole numbers: the fold's float atomics add exactly in any order
    p, t = torch.randint(0, 8, (64,), device=cuda).float(), torch.randint(0, 8, (64,), device=cuda).float()
    ids = torch.arange(64, device=cuda, dtype=torch.int32) % 4
    base, m = MeanSquaredError(fleet_size=4), MeanSquaredError(fleet_size=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fault.FaultSchedule(fire_at={"fleet.compile": 0}) as sched:
            m.update(p, t, stream_ids=ids)
        m.update(p, t, stream_ids=ids)
    base.update(p, t, stream_ids=ids)
    base.update(p, t, stream_ids=ids)
    assert sched.fired[0]["site"] == "fleet.compile" and fleet.step_stats(m)["degrades"] == 1
    assert torch.equal(m.compute(), base.compute())


@pytest.mark.cuda
def test_prewarmed_chain_replays_with_no_capture_on_another_thread_on_card(cuda):
    """A warm manifest recorded on the card, captured by ``excache.prewarm`` on this
    thread, is replayed by ticks run on another thread with no capture at all; the
    state is bit-equal to a cold run of the same batches. A fleet's routed step is
    prewarmed the same way."""
    import threading

    from metrics_tpu_torch.core import fleet
    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.serve import IngestQueue, excache

    g = torch.Generator(device=cuda).manual_seed(13)
    batches = [(torch.rand(4096, generator=g, device=cuda),
                torch.randint(0, 2, (4096,), generator=g, device=cuda, dtype=torch.int32)) for _ in range(8)]
    groups = (3, 1, 3, 1)

    def run(queue, on_thread):
        it = iter(batches)
        for size in groups:
            for _ in range(size):
                queue.enqueue(*next(it))
            worker = threading.Thread(target=queue.flush) if on_thread else None
            if worker is None:
                queue.flush()
            else:
                worker.start()
                worker.join(timeout=120)
        torch.cuda.synchronize()

    excache.enable_recording(clear=True)
    try:
        cold = canonical_collection(True)
        with IngestQueue(cold, start=False) as q:
            run(q, on_thread=False)
            assert q.step_stats["cache_misses"] == 2
        manifest = excache.manifest_payload()
        ids = torch.arange(4096, device=cuda, dtype=torch.int32) % 4
        # whole numbers: the fold's float atomics add exactly in any order
        whole = (torch.floor(batches[0][0] * 8), torch.floor(batches[1][0] * 8))
        recorded = MeanSquaredError(fleet_size=4)
        recorded.update(*whole, stream_ids=ids)
        fleet_manifest = excache.manifest_payload()
    finally:
        excache.disable_recording()
        excache.clear_manifest()
    assert [e["engine"] for e in manifest["entries"]] == ["ingest", "ingest"]
    warm = canonical_collection(True)
    with IngestQueue(warm, start=False) as q:
        report = excache.prewarm(q, manifest)
        assert report == dict(report, entries=2, compiled=2, skipped=0, failed=0)
        run(q, on_thread=True)
        assert q.step_stats["cache_misses"] == 0 and q.step_stats["cache_hits"] == 4
        assert q.stats["degrades"] == 0 and all(isinstance(s, CapturedStep) for s in q._steps.steps.values())
    got, want = warm.compute(), cold.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    fresh = MeanSquaredError(fleet_size=4)
    assert excache.prewarm(fresh, fleet_manifest)["compiled"] == 1
    fresh.update(*whole, stream_ids=ids)
    assert fleet.step_stats(fresh)["cache_misses"] == 0 and fleet.step_stats(fresh)["cache_hits"] == 1
    assert torch.equal(fresh.compute(), recorded.compute())


@pytest.mark.cuda
def test_captures_run_on_a_stream_no_producer_can_draw(cuda):
    """PyTorch hands out ``torch.cuda.Stream()`` round-robin from a pool of 32, and
    ``torch.cuda.graph`` captures on one of them by default; the port's captures run on a
    stream of the high-priority pool, which no default ``torch.cuda.Stream()`` can be."""
    from metrics_tpu_torch.core.fused import _capture_stream

    handle = _capture_stream(torch.device(cuda)).cuda_stream
    assert _capture_stream(torch.device(cuda)).cuda_stream == handle  # one a device
    assert handle not in {torch.cuda.Stream().cuda_stream for _ in range(96)}


@pytest.mark.cuda
def test_a_failed_capture_leaves_the_callers_stream_current_on_card(cuda):
    """``torch.cuda.graph`` restores the caller's stream only when its capture ends
    cleanly. A capture that a host read invalidated used to leave the capture stream
    current on the capturing thread: its later work then ran unordered with the other
    threads' default stream, and a reader there saw a state before the last replay."""
    from metrics_tpu_torch.core.fused import CapturedStep, _capture_stream

    def host_read(states, x):
        if float(x.sum()) > -1:  # the warm-up runs it; a capture cannot
            return {"s": states["s"] + x}, None
        return states, None

    device = torch.device(cuda)
    for caller in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(caller):
            with pytest.raises(Exception):
                CapturedStep(host_read, {"s": torch.zeros(4, device=cuda)}, [torch.ones(4, device=cuda)], device)
            assert torch.cuda.current_stream() == caller
            assert torch.cuda.current_stream() != _capture_stream(device)


@pytest.mark.cuda
@pytest.mark.parametrize("ticker", ["thread", "caller"])
def test_ingest_reader_on_another_stream_sees_every_tick_on_card(cuda, ticker):
    """The tick thread replays on its own current stream. A caller whose current
    stream is another one (a side stream; or the capture stream a failed capture left
    current) reads the target right after ``flush``: it sees every batch, because
    ``flush`` orders the caller's stream after the last tick's event. With
    ``ticker="caller"`` the ticks alternate between the tick thread and ``tick()``
    calls on the caller's stream, and each tick waits for the one before."""
    from metrics_tpu_torch.core.fused import canonical_collection
    from metrics_tpu_torch.serve import IngestQueue

    g = torch.Generator(device=cuda).manual_seed(23)
    batches = [(torch.rand(8192, generator=g, device=cuda),
                torch.randint(0, 2, (8192,), generator=g, device=cuda, dtype=torch.int32)) for _ in range(64)]
    sync = canonical_collection(True)
    for p, t in batches:
        sync.update(p, t)
    want = sync.compute()
    reader = torch.cuda.Stream()
    for trial in range(3):
        target = canonical_collection(True)
        with torch.cuda.stream(reader):
            with IngestQueue(target, capacity=16, tick_interval_s=0.0005, max_coalesce=8) as q:
                for i, (p, t) in enumerate(batches):
                    q.enqueue(p * 1.0, t + 0)
                    if ticker == "caller" and i % 5 == 4:
                        q.tick(3)
                q.flush()
                got = target.compute()
                assert q.stats["degrades"] == 0 and q.stats["enqueued"] == 64
        # the read ran on the reader stream: order this stream's comparison after it
        torch.cuda.current_stream().wait_stream(reader)
        diff = {k: (got[k].tolist(), want[k].tolist()) for k in want if not torch.equal(got[k], want[k])}
        assert not diff, f"trial {trial}: the read missed applied batches: {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("freer", ["capturing_thread", "other_thread"])
def test_a_step_freed_while_another_captures_leaves_that_capture_whole_on_card(cuda, freer):
    """Freeing a captured step's CUDA graph while a capture is open invalidates that
    capture: the graph's ``cudaGraphExecDestroy`` is refused ("operation not permitted when
    stream is capturing") and the open capture ends with "a previous error during capture"
    (the ingest queue's degraded ticks of ROADMAP C 13, where the collector freed an
    earlier test's steps during a tick's capture). A step freed then keeps its graph until
    no capture is open. Each trial frees a step in the middle of another step's capture, on
    the capturing thread or on another one."""
    import threading

    from metrics_tpu_torch.core.fused import CapturedStep

    device = torch.device(cuda)
    x = torch.ones(16, device=cuda)
    for _trial in range(20):
        doomed = [CapturedStep(lambda s, e: ({"s": s["s"] + e}, None), {"s": torch.zeros(16, device=cuda)}, [x],
                               device)]

        def free():
            doomed.clear()  # the last reference: the step and its graph go here

        def step(states, extra):
            if torch.cuda.is_current_stream_capturing() and doomed:
                if freer == "capturing_thread":
                    free()
                else:
                    t = threading.Thread(target=free)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
            return {"s": states["s"] * 2 + extra}, None

        captured = CapturedStep(step, {"s": torch.zeros(16, device=cuda)}, [x], device)
        assert doomed == []  # the capture ran the step's body
        new, _ = captured({"s": torch.zeros(16, device=cuda)}, [x])
        assert torch.equal(new["s"], x)


@pytest.mark.cuda
def test_a_capture_under_a_live_profiler_keeps_its_ranges_on_the_host_on_card(cuda, tmp_path):
    """With obs on and ``obs.trace`` running, the fused engine's first step captures its
    graph inside a ``tm.fused/step`` ``record_function`` range: the range stays on the
    host (the capture succeeds, nothing demotes), and the replays compute what an eager
    collection computes. The trace holds the ranges, and one histogram kernel for the
    capture's warm-up and one for each replay."""
    import json

    from metrics_tpu_torch import obs
    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection, engine_for

    g = torch.Generator(device=cuda).manual_seed(29)
    batches = [(torch.rand(4096, generator=g, device=cuda),
                torch.randint(0, 2, (4096,), generator=g, device=cuda, dtype=torch.int32)) for _ in range(6)]
    eager = canonical_collection(False)
    fused = canonical_collection(True)
    try:
        with obs.trace(str(tmp_path)) as path:
            for p, t in batches:
                fused.update(p, t)
            torch.cuda.synchronize()
        steps = engine_for(fused)._steps
        assert steps.stats["degrades"] == 0 and steps.stats["cache_misses"] == 1
        assert all(isinstance(s, CapturedStep) for s in steps.steps.values())
    finally:
        obs.disable()
    for p, t in batches:
        eager.update(p, t)
    got, want = fused.compute(), eager.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "tm.fused/step" and e.get("cat") != "gpu_user_annotation") == 6
    # the capture's warm-up and the six replays (the first step's replay included)
    assert sum(1 for e in events if e.get("cat") == "kernel" and "histogram_kernel" in str(e.get("name"))) == 7
