"""The segmented multi-scan of metrics_tpu_torch against metrics_tpu, on the CPU.

``segment_multi_scan(..., device CPU)`` runs the port's plain version, the CUDA
kernel's reference. It must be bit-equal to the JAX package's ``segment_multi_scan``:
forward runs through the Pallas kernel in interpret mode (``force_scan_impl(
"pallas_interpret")``, as tests/unittests/classification/test_segment_multi_scan.py
runs it), reverse runs through the ``associative_scan`` tier. The cases are that
file's: tiny, ±inf-driven boundaries, block multiples, one row per segment, one
global segment, long tie runs. int64 lanes, which the JAX package narrows to int32
without x64, are held against a per-row numpy reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.segment import SEGSCAN_BLOCK, force_scan_impl
from metrics_tpu.ops.segment import segment_multi_scan as jax_scan
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_multi_scan
from tests.torch_deadline import deadline  # noqa: F401

_rng = np.random.RandomState(4321)
_NP_OP = {"sum": np.add, "min": np.minimum, "max": np.maximum}
OPS3 = ("sum", "min", "max")


def _np_segment_scan(values, flags, op, reverse=False):
    """Per-row reference: inclusive within-segment running statistic."""
    v, f = np.asarray(values).copy(), np.asarray(flags).astype(bool).copy()
    if reverse:
        v, f = v[::-1], f[::-1]
    out = np.empty_like(v)
    acc = None
    with np.errstate(over="ignore"):
        for i in range(len(v)):
            acc = v[i] if (f[i] or acc is None) else _NP_OP[op](acc, v[i])
            out[i] = acc
    return out[::-1] if reverse else out


def _flags_from_preds(preds):
    order = np.argsort(-preds, kind="stable")
    s = preds[order]
    flags = np.ones(len(s), bool)
    flags[1:] = s[1:] != s[:-1]
    return flags


def _cases():
    cases = {}
    for name, preds in {
        "tie_heavy": (_rng.randint(0, 5, 1300) / 4.0).astype(np.float32),
        "pm_inf": np.where(
            _rng.rand(777) < 0.2, np.inf, np.where(_rng.rand(777) < 0.2, -np.inf, _rng.randn(777))
        ).astype(np.float32),
        "random": _rng.randn(900).astype(np.float32),
    }.items():
        cases[name] = (_rng.randint(-7, 8, len(preds)).astype(np.int32), _flags_from_preds(preds))
    n = 2048
    cases["every_row_a_segment"] = (_rng.randint(0, 100, n).astype(np.int32), np.ones(n, bool))
    cases["one_global_segment"] = (_rng.randint(-100, 100, n).astype(np.int32), np.eye(1, n, 0, dtype=bool)[0])
    cases["block_multiple"] = (
        _rng.randint(0, 3, SEGSCAN_BLOCK * 3).astype(np.int32),
        _rng.rand(SEGSCAN_BLOCK * 3) < 0.01,
    )
    cases["tiny"] = (np.array([5, -2, 3], np.int32), np.array([True, False, True]))
    return cases


CASES = _cases()
# the Pallas interpreter runs block by block in Python: its subset, as in the JAX file
PALLAS_CASES = ("tiny", "pm_inf", "block_multiple", "every_row_a_segment")


def _lanes(vals):
    """Three lanes of one case: the values, a shifted copy, and extremes for min/max."""
    info = np.iinfo(np.int32)
    big = np.where(_rng.rand(len(vals)) < 0.1, info.max, np.where(_rng.rand(len(vals)) < 0.1, info.min, vals * 3))
    return (vals, (vals + 1).astype(np.int32), big.astype(np.int32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_equal_to_jax(case, reverse):
    vals, flags = CASES[case]
    lanes = _lanes(vals)
    impl = "assoc" if reverse or case not in PALLAS_CASES else "pallas_interpret"
    with force_scan_impl(impl):
        want = jax_scan(tuple(jnp.asarray(v) for v in lanes), jnp.asarray(flags), ops=OPS3, reverse=reverse)
    got = segment_multi_scan([torch.from_numpy(v) for v in lanes], torch.from_numpy(flags), ops=OPS3, reverse=reverse)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w)), f"{case} reverse={reverse}"


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", ["random", "one_global_segment", "tiny"])
def test_global_segment_bit_equal_to_jax(case, reverse):
    vals, _ = CASES[case]
    lanes = _lanes(vals)
    with force_scan_impl("pallas_interpret" if not reverse else "assoc"):
        want = jax_scan(tuple(jnp.asarray(v) for v in lanes), None, ops=OPS3, reverse=reverse)
    got = segment_multi_scan([torch.from_numpy(v) for v in lanes], None, ops=OPS3, reverse=reverse)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_curve_path_lanes_bit_equal_to_jax():
    """The exact-curve call: two int32 ``min`` lanes, one global segment, reverse."""
    n = 3 * SEGSCAN_BLOCK + 77
    boundary = _rng.rand(n) < 0.3
    boundary[-1] = True
    tps_all = np.cumsum(_rng.rand(n) < 0.4).astype(np.int32)
    lanes = (np.where(boundary, tps_all, np.int32(2**31 - 1)), np.where(boundary, np.arange(n), n - 1).astype(np.int32))
    with force_scan_impl("assoc"):
        want = jax_scan(tuple(jnp.asarray(v) for v in lanes), None, ops=("min", "min"), reverse=True)
    got = segment_multi_scan([torch.from_numpy(v) for v in lanes], None, ops=("min", "min"), reverse=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", ["pm_inf", "block_multiple", "every_row_a_segment"])
def test_int64_lanes(case, reverse):
    vals, flags = CASES[case]
    info = np.iinfo(np.int64)
    wide = vals.astype(np.int64) * (1 << 40)
    extremes = np.where(_rng.rand(len(vals)) < 0.1, info.max, np.where(_rng.rand(len(vals)) < 0.1, info.min, wide))
    lanes = (wide, extremes, extremes, wide)
    ops = ("sum", "min", "max", "max")
    got = segment_multi_scan([torch.from_numpy(v) for v in lanes], torch.from_numpy(flags), ops=ops, reverse=reverse)
    for g, v, op in zip(got, lanes, ops):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), _np_segment_scan(v, flags, op, reverse))


def test_narrow_lanes_keep_their_dtype_and_wrap():
    vals = np.array([100, 100, 100, -128, 127, 5], np.int8)
    flags = np.array([True, False, False, False, True, False])
    for op in OPS3:
        (got,) = segment_multi_scan([torch.from_numpy(vals)], torch.from_numpy(flags), ops=(op,))
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), _np_segment_scan(vals, flags, op))


def test_sum_wraps_like_jax():
    vals = np.array([2**31 - 1, 1, 5, -(2**31), -1], np.int32)
    (want,) = jax_scan((jnp.asarray(vals),), None)
    (got,) = segment_multi_scan([torch.from_numpy(vals)], None)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_errors_match_jax():
    v = torch.arange(5, dtype=torch.int32)
    for bad in ([v.float()], [v.to(torch.bool)]):
        with pytest.raises(ValueError, match="integer-only"):
            segment_multi_scan(bad, None)
    with pytest.raises(ValueError, match="unknown scan op"):
        segment_multi_scan([v], None, ops=("prod",))
    with pytest.raises(ValueError, match="at least one"):
        segment_multi_scan([], None)
    with pytest.raises(ValueError, match="ops"):
        segment_multi_scan([v, v], None, ops=("sum",))
    with pytest.raises(ValueError):
        segment_multi_scan([v, v[:3]], None)
    # the JAX package raises the same way on the same inputs
    with pytest.raises(ValueError, match="integer-only"):
        jax_scan((jnp.arange(5.0),), None)
    with pytest.raises(ValueError, match="unknown scan op"):
        jax_scan((jnp.arange(5),), None, ops=("prod",))


def test_cpu_lanes_take_the_plain_version():
    vals, flags = CASES["block_multiple"]
    before = segment.segment_scan_cuda.launches
    got = segment_multi_scan([torch.from_numpy(vals)] * 5, torch.from_numpy(flags), ops=OPS3 + ("sum", "min"))
    want = _plain_multi_scan([torch.from_numpy(vals)] * 5, torch.from_numpy(flags), OPS3 + ("sum", "min"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert segment.segment_scan_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_lanes():
    v = torch.arange(5, dtype=torch.int32)
    before = segment.segment_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        segment.segment_scan_cuda([v], None, ("sum",))
    assert segment.segment_scan_cuda.launches == before
