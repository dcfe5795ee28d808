"""The sketch family of metrics_tpu_torch against metrics_tpu, on the CPU.

Seeded numpy inputs go through the JAX package's ``ops/sketch.py`` and ``sketches/``
and the port's (``device="cpu"``). Tolerances:

- bit-equal: hashes (int32 with negatives, bool, float32 with ±0.0 and NaN, float16
  and bfloat16 from the same bits; seeds 0, 1 and 2^31-1), HLL indices and ranks for
  p = 4..16, registers and every integer state;
- ``log_bucket_index``: the same bucket everywhere except where the float64 value of
  ``(log(mag) - log(min_value)) / log γ`` lies within 1e-5 of an integer, and at most
  one bucket over there (``torch.log`` and XLA's ``log`` may differ by one ulp). The
  band is for the default ``relative_error=0.01``; it widens as ``1 / log γ``;
- 1e-6 relative for the float32 bucket midpoints, the quantile values drawn from them
  and the HLL estimates (``torch.exp`` and XLA's ``exp`` may differ by one ulp, and
  these values reach 10^8); 1e-6 absolute for bounds and divergences. The AP bracket of
  ``StreamingAUROCBound`` is held to the float64 closed forms of the port's bracket
  (``tests/torch_sketch_helpers.py``), which fixes two faults of the JAX package's.

The deliberate deviation: past 2^24 values the port's quantile slot is the exact
rank's, where the JAX package's float32 cumulative counts miss it.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import metrics_tpu.sketches as js
import metrics_tpu_torch
import metrics_tpu_torch.sketches as ts
from metrics_tpu.ops import sketch as jops
from metrics_tpu.utils.exceptions import MetricsUserError as JaxMetricsUserError
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.ops import sketch as tops
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.torch_sketch_helpers import ap_bounds64
from tests.torch_deadline import deadline  # noqa: F401

CPU = "cpu"
ATOL = 1e-6
RTOL = 1e-6
SEEDS = (0, 1, 2**31 - 1)
BATCH = 2_000


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol: float = ATOL, rtol: float = 0.0) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            assert_close(got[key], want[key], atol, rtol)
        return
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.bool_:
        assert np.array_equal(got, want)
        return
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def assert_states_equal(port, jax_metric) -> None:
    for name in jax_metric._defaults:
        want = np.asarray(getattr(jax_metric, name))
        got = _np(getattr(port, name))
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


# ------------------------------------------------------------------ ops/sketch.py


def _hash_inputs(kind: str, rng):
    """(jax input, port input) of one dtype, from the same bits."""
    if kind == "int32":
        x = rng.integers(-(2**31), 2**31, 4_096).astype(np.int32)
        x[:4] = [0, -1, 2**31 - 1, -(2**31)]
        return jnp.asarray(x), torch.from_numpy(x)
    if kind == "bool":
        x = rng.random(256) < 0.5
        return jnp.asarray(x), torch.from_numpy(x)
    f = rng.standard_normal(4_096).astype(np.float32) * 1e3
    f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    if kind == "float32":
        return jnp.asarray(f), torch.from_numpy(f)
    if kind == "float16":
        h = f.astype(np.float16)
        return jnp.asarray(h), torch.from_numpy(h)
    b = f.astype(ml_dtypes.bfloat16)  # the bits, not torch's own rounding of NaN
    return jnp.asarray(b), torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["int32", "bool", "float32", "float16", "bfloat16"])
def test_hash_u32_bit_equal(kind, seed):
    jx, tx = _hash_inputs(kind, np.random.default_rng(7))
    want = np.asarray(jops.hash_u32(jx, seed)).astype(np.int64)
    got = tops.hash_u32(tx, seed)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_hash_folds_negative_zero_and_wide_ints_keep_low_bits():
    pair = tops.hash_u32(torch.tensor([0.0, -0.0]))
    assert pair[0] == pair[1]
    wide = torch.tensor([-1, 5, (1 << 40) + 5], dtype=torch.int64)
    assert torch.equal(tops.hash_u32(wide), tops.hash_u32(torch.tensor([-1, 5, 5], dtype=torch.int32)))
    assert tops._mix_seed(3) == jops._mix_seed(3)


def test_mul_u32_low_bits_exact():
    rng = np.random.default_rng(3)
    h = np.concatenate([rng.integers(0, 2**32, 10_000, dtype=np.int64), [0, 1, 2**32 - 1, 2**31]])
    for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1):
        want = np.array([(int(v) * c) & 0xFFFFFFFF for v in h], dtype=np.int64)
        assert np.array_equal(tops._mul_u32(torch.from_numpy(h), c).numpy(), want)
    fm = np.asarray(jops.fmix32(jnp.asarray(h.astype(np.uint32)))).astype(np.int64)
    assert np.array_equal(tops.fmix32(torch.from_numpy(h)).numpy(), fm)


@pytest.mark.parametrize("p", list(range(4, 17)))
def test_hll_index_rank_bit_equal(p):
    rng = np.random.default_rng(p)
    h = rng.integers(0, 2**32, 8_192, dtype=np.int64)
    # every rank: the first set bit after the index at each position, and none
    tail = [((1 << (31 - p - k)) if k < 32 - p else 0) for k in range(33 - p)]
    h[: len(tail)] = tail
    h[len(tail):len(tail) + 3] = [2**32 - 1, 1, 2**31]
    ji, jr = jops.hll_index_rank(jnp.asarray(h.astype(np.uint32)), p)
    ti, tr = tops.hll_index_rank(torch.from_numpy(h), p)
    assert tr.dtype == torch.uint8
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tr.numpy(), np.asarray(jr))
    assert int(tr.max()) <= 33 - p
    with pytest.raises(ValueError):
        tops.hll_index_rank(torch.from_numpy(h), 3)


@pytest.mark.parametrize("bits", [11, 16])
def test_log_bucket_index_edge_rule(bits):
    rel, min_value = 0.01, 1e-9
    log_gamma = math.log(tops.quantile_gamma(rel))
    nb = 1 << bits
    rng = np.random.default_rng(bits)
    with np.errstate(over="ignore"):
        edges = min_value * np.exp(log_gamma * np.arange(nb + 1))
    edges = edges[edges < 3e38].astype(np.float32)
    mags = np.concatenate([
        edges, np.nextafter(edges, np.float32(np.inf)), np.nextafter(edges, np.float32(0)),
        np.exp(rng.uniform(math.log(min_value) - 2, 88.0, 50_000)).astype(np.float32),
        np.array([0.0, np.inf, np.nan, 1e-45, 3.4e38], np.float32),
    ])
    want = np.asarray(jops.log_bucket_index(jnp.asarray(mags), log_gamma, min_value, nb))
    got = tops.log_bucket_index(torch.from_numpy(mags), log_gamma, min_value, nb).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        e = (np.log(mags.astype(np.float64)) - math.log(min_value)) / log_gamma
        near = np.isfinite(e) & (np.abs(e - np.round(e)) < 1e-5)
    assert np.array_equal(got[~near], want[~near])
    assert np.all(np.abs(got[near] - want[near]) <= 1)


def test_bucket_midpoints_and_constants():
    for rel in (0.01, 0.05):
        log_gamma = math.log(tops.quantile_gamma(rel))
        assert tops.quantile_gamma(rel) == jops.quantile_gamma(rel)
        want = np.asarray(jops.bucket_midpoints(2048, log_gamma, 1e-9))
        assert_close(tops.bucket_midpoints(2048, log_gamma, 1e-9), want, atol=0.0, rtol=RTOL)
    for m in (16, 32, 64, 128, 4096):
        assert tops.hll_alpha(m) == jops.hll_alpha(m)
    with pytest.raises(ValueError):
        tops.quantile_gamma(1.0)


@pytest.mark.parametrize("case", ["empty", "small", "mid", "saturated"])
def test_hll_estimate(case):
    rng = np.random.default_rng(len(case))
    m = 4096
    regs = {
        "empty": np.zeros(m, np.uint8),
        "small": np.where(rng.random(m) < 0.1, rng.integers(1, 4, m), 0).astype(np.uint8),
        "mid": rng.integers(1, 12, m).astype(np.uint8),
        "saturated": rng.integers(18, 21, m).astype(np.uint8),
    }[case]
    want = np.asarray(jops.hll_estimate(jnp.asarray(regs)))
    assert_close(tops.hll_estimate(torch.from_numpy(regs)), want, atol=0.0, rtol=RTOL)


# ------------------------------------------------------------------ the four classes


def _batches(name: str, seed: int, count: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        if name == "QuantileSketch":
            x = (rng.standard_normal(BATCH) * rng.choice([1e-3, 1.0, 1e4], BATCH)).astype(np.float32)
            x[:5] = [0.0, -0.0, np.nan, np.inf, 1e-12]
            out.append((x,))
        elif name == "DistinctCount":
            out.append((rng.integers(0, 1_500, BATCH).astype(np.int32),))
        elif name == "HistogramDrift":
            x = rng.beta(2.0, 5.0, BATCH).astype(np.float32) * 1.2 - 0.1
            x[:3] = [np.nan, np.inf, -np.inf]
            out.append((x,))
        else:
            t = rng.integers(0, 2, BATCH)
            out.append((np.clip(rng.random(BATCH) * 0.7 + 0.3 * t, 0, 1).astype(np.float32), t.astype(np.int32)))
    return out


CLASSES = {
    "QuantileSketch": {"quantiles": (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)},
    "DistinctCount": {"p": 10},
    "HistogramDrift": {"num_bins": 32},
    "StreamingAUROCBound": {"bits": 10},
}
VALUE_RTOL = {"QuantileSketch": RTOL, "DistinctCount": RTOL}


def _pair(name: str, **extra):
    kwargs = {**CLASSES[name], **extra}
    return getattr(js, name)(**kwargs), getattr(ts, name)(device=CPU, **kwargs)


def _assert_values(name, got, want, port=None):
    if name == "StreamingAUROCBound":  # the port's AP bracket from the metric's histograms
        lo, hi = ap_bounds64(_np(port.pos_hist), _np(port.neg_hist))
        want = {**{k: v for k, v in want.items() if k.startswith("auroc")},
                "ap_lower": lo, "ap_mid": 0.5 * (lo + hi), "ap_upper": hi}
    assert_close(got, want, atol=0.0 if name in VALUE_RTOL else ATOL, rtol=VALUE_RTOL.get(name, 0.0))


@pytest.mark.parametrize("name", list(CLASSES))
def test_class_updates_forward_reset(name):
    jm, tm = _pair(name)
    for batch in _batches(name, 11):
        want_step = jm(*[jnp.asarray(a) for a in batch])
        got_step = tm(*[torch.from_numpy(a) for a in batch])
        alone = getattr(ts, name)(device=CPU, **CLASSES[name])  # the batch's own state
        alone.update(*[torch.from_numpy(a) for a in batch])
        _assert_values(name, got_step, want_step, alone)
    assert_states_equal(tm, jm)
    _assert_values(name, tm.compute(), jm.compute(), tm)
    tm.reset()
    assert all(torch.equal(getattr(tm, n), tm._defaults[n]) for n in tm._defaults)


@pytest.mark.parametrize("name", list(CLASSES))
def test_merge_in_both_orders_equals_compute_on_concat(name):
    batches = _batches(name, 12, count=4)
    whole = getattr(ts, name)(device=CPU, **CLASSES[name])
    a, b = getattr(ts, name)(device=CPU, **CLASSES[name]), getattr(ts, name)(device=CPU, **CLASSES[name])
    for i, batch in enumerate(batches):
        args = [torch.from_numpy(x) for x in batch]
        whole.update(*args)
        (a if i % 2 else b).update(*args)
    ab, ba = a.clone(), b.clone()
    ab.merge(b)
    ba.merge(a)
    for merged in (ab, ba):
        assert all(torch.equal(getattr(merged, n), getattr(whole, n)) for n in whole._defaults)
    jm = getattr(js, name)(**CLASSES[name])
    jm.update(*[jnp.asarray(np.concatenate(parts)) for parts in zip(*batches)])
    _assert_values(name, ab.compute(), jm.compute(), ab)


def test_quantile_sketch_bits_16_scatter_path():
    # 2^16 buckets of γ past 1.0108 overflow ``max_value`` in both packages
    jm, tm = _pair("QuantileSketch", bits=16, relative_error=0.005)
    for batch in _batches("QuantileSketch", 13):
        jm.update(jnp.asarray(batch[0]))
        tm.update(torch.from_numpy(batch[0]))
    assert_states_equal(tm, jm)
    assert tm.pos_buckets.shape == (1 << 16,)
    _assert_values("QuantileSketch", tm.compute(), jm.compute())


def test_quantile_slots_equal_the_jax_package_below_2_24():
    """Below 2^24 values the port's slot is the JAX package's, also where a level's
    float32 rank rounds (0.9 x 10) and on counts at bucket edges."""
    levels = tuple(np.linspace(0.0, 1.0, 101).tolist())
    rng = np.random.default_rng(14)
    for total in (1, 2, 11, 101, 1 << 12):
        x = np.exp(rng.normal(0.0, 3.0, total)).astype(np.float32) * rng.choice([-1.0, 1.0], total).astype(np.float32)
        jm, tm = _pair("QuantileSketch", quantiles=levels)
        jm.update(jnp.asarray(x))
        tm.update(torch.from_numpy(x))
        _assert_values("QuantileSketch", tm.compute(), jm.compute())


def test_quantile_slot_past_2_24_is_the_exact_rank():
    """The deliberate deviation: cumulative counts in int64 and float64 ranks."""
    state = {
        "pos_buckets": np.zeros(16, np.int32), "neg_buckets": np.zeros(16, np.int32),
        "edge_counts": np.zeros(5, np.int32), "nan_count": np.zeros((), np.int32),
    }
    state["pos_buckets"][[0, 1, 2]] = [1 << 25, 1, 2]  # 2^25 + 3 values
    jm = js.QuantileSketch(bits=4, quantiles=(0.5, 1.0))
    for name, value in state.items():
        setattr(jm, name, jnp.asarray(value))
    tm = load_jax_state(ts.QuantileSketch(bits=4, quantiles=(0.5, 1.0), device=CPU), state)
    got, want = tm.compute(), jm.compute()
    est = tops.bucket_midpoints(16, tm._log_gamma, tm.min_value)
    # the maximum (rank 2^25 + 2) lies in bucket 2: the port's slot
    assert got["quantiles"][1] == est[2] and bool(got["certified"][1])
    # the JAX package's float32 sums round it past every bucket, into the overflow bin
    assert float(want["quantiles"][1]) == pytest.approx(tm.max_value, rel=1e-6) and not bool(want["certified"][1])
    assert got["quantiles"][0] == est[0]


def test_histogram_drift_reference_and_reset_live():
    jm, tm = _pair("HistogramDrift")
    ref, live, later = _batches("HistogramDrift", 15)
    jm.update(jnp.asarray(ref[0]), reference=True)
    tm.update(torch.from_numpy(ref[0]), reference=True)
    jm.update(jnp.asarray(live[0] ** 2))
    tm.update(torch.from_numpy(live[0] ** 2))
    assert_states_equal(tm, jm)
    _assert_values("HistogramDrift", tm.compute(), jm.compute())
    jm.reset_live()
    tm.reset_live()
    assert int(tm.live_hist.sum()) == 0 and int(tm.ref_hist.sum()) > 0
    jm.update(jnp.asarray(later[0]))
    tm.update(torch.from_numpy(later[0]))
    assert_states_equal(tm, jm)
    _assert_values("HistogramDrift", tm.compute(), jm.compute())


def test_sketch_metric_refusals_match_the_jax_package():
    class FloatState(ts.SketchMetric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_sketch_state("x", torch.zeros(3), "sum")

        def update(self):
            pass

        def compute(self):
            return self.x

    class CatState(ts.SketchMetric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_sketch_state("x", torch.zeros(3, dtype=torch.int32), "cat")

        def update(self):
            pass

        def compute(self):
            return self.x

    with pytest.raises(MetricsUserError, match="integer array"):
        FloatState(device=CPU)
    with pytest.raises(MetricsUserError, match="mergeable reduction"):
        CatState(device=CPU)
    with pytest.raises(MetricsUserError, match="same class"):
        ts.DistinctCount(device=CPU).merge(ts.QuantileSketch(device=CPU))
    with pytest.raises(JaxMetricsUserError, match="same class"):
        js.DistinctCount().merge(js.QuantileSketch())
    assert type(MetricsUserError).__name__ == type(JaxMetricsUserError).__name__
    for name, bad in (("QuantileSketch", {"bits": 3}), ("DistinctCount", {"p": 17}),
                      ("HistogramDrift", {"num_bins": 1}), ("StreamingAUROCBound", {"bits": 15})):
        with pytest.raises(ValueError):
            getattr(ts, name)(device=CPU, **bad)
        with pytest.raises(ValueError):
            getattr(js, name)(**bad)


@pytest.mark.parametrize("name", list(CLASSES))
def test_state_bytes_and_root_exports(name):
    jm, tm = _pair(name)
    assert tm.state_bytes() == jm.state_bytes()
    assert getattr(metrics_tpu_torch, name) is getattr(ts, name)


@pytest.mark.parametrize("name", list(CLASSES))
def test_load_jax_state_then_update_both(name):
    first, second = _batches(name, 16, count=2)
    jm = getattr(js, name)(**CLASSES[name])
    jm.update(*[jnp.asarray(a) for a in first])
    jm.persistent(True)
    tm = load_jax_state(getattr(ts, name)(device=CPU, **CLASSES[name]), jm.state_dict())
    assert_states_equal(tm, jm)
    jm.update(*[jnp.asarray(a) for a in second])
    tm.update(*[torch.from_numpy(a) for a in second])
    assert_states_equal(tm, jm)
    _assert_values(name, tm.compute(), jm.compute(), tm)


def test_quantile_sketch_pure_tier_equals_eager():
    tm = ts.QuantileSketch(device=CPU, **CLASSES["QuantileSketch"])
    eager = ts.QuantileSketch(device=CPU, **CLASSES["QuantileSketch"])
    state = tm.init_state()
    for batch in _batches("QuantileSketch", 17):
        state = tm.local_update(state, torch.from_numpy(batch[0]))
        eager.update(torch.from_numpy(batch[0]))
    assert int(tm.pos_buckets.sum()) == 0  # the live state is untouched
    assert all(torch.equal(state[n], getattr(eager, n)) for n in eager._defaults)
    got, want = tm.compute_from(state), eager.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_distinct_count_fleet_routes_like_separate_sketches():
    rng = np.random.default_rng(18)
    fleet = ts.DistinctCount(p=8, fleet_size=4, device=CPU)
    apart = [ts.DistinctCount(p=8, device=CPU) for _ in range(4)]
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, 10_000, 500))
        sid = torch.from_numpy(rng.integers(0, 3, 500))  # stream 3 stays empty
        fleet.update(ids, stream_ids=sid)
        for s in range(4):
            apart[s].update(ids[sid == s])
    assert fleet.registers.dtype == torch.uint8
    assert all(torch.equal(fleet.registers[s], apart[s].registers) for s in range(4))
    values = fleet.compute()
    assert values.shape == (4,) and float(values[3]) == 0.0


def test_sketches_in_a_fused_collection_equal_eager():
    coll = MetricCollection({n: getattr(ts, n)(device=CPU, **CLASSES[n]) for n in ("QuantileSketch", "DistinctCount")},
                            fused=True)
    eager = {n: getattr(ts, n)(device=CPU, **CLASSES[n]) for n in ("QuantileSketch", "DistinctCount")}
    for batch in _batches("QuantileSketch", 19):
        x = torch.from_numpy(batch[0])
        coll.update(x)
        for m in eager.values():
            m.update(x)
    for n, m in eager.items():
        assert all(torch.equal(getattr(coll[n], s), getattr(m, s)) for s in m._defaults)
