"""The wrappers' stacked paths and pure tier of metrics_tpu_torch against metrics_tpu,
on the CPU.

- The sampler: the Poisson(1) CDF table bit-equal to the JAX package's, and
  ``_indices_from_draws`` bit-equal to JAX ``BootStrapper._device_sample`` given the
  uniforms and pads drawn from the same JAX keys, both strategies, truncated and
  padded draws.
- The stacked eager update: the JAX stacked path's indices replayed through the port's
  seam (``_stacked_update_with_indices``): ``boot_<name>`` bit-equal, ``mean``/``std``/
  ``quantile``/``raw`` within 1e-6; the port's own draws replayed into JAX base metrics.
- The pure tier (``init_state``/``local_update``/``compute_from``) against the JAX pure
  tier fed the same indices: MulticlassAccuracy micro and macro, BinaryAUROC with
  ``cat_capacity`` (an overflow poisons to NaN); seeded replays; the list-state guard
  and the ``cat`` sync refusal with the JAX messages. The 2-rank ``sync_state`` is in
  ``tests/test_torch_pure.py``.
- ``fleet_size``: BootStrapper's state shapes and routed counts bit-equal to JAX's,
  ClasswiseWrapper over a fleet inner metric, MinMaxMetric's stream axis over several
  updates (and its refusal of ``stream_ids``), MultioutputWrapper's refusal.
- MultioutputWrapper's pure tier (the JAX package's ``test_wrappers_pure.py`` cases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.regression as jreg
import metrics_tpu.wrappers as jw
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.regression as treg
import metrics_tpu_torch.wrappers as tw
from metrics_tpu.utils.exceptions import MetricsUserError as JaxMetricsUserError
from metrics_tpu_torch.parallel import evaluate_sharded
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.wrappers.bootstrapping import _indices_from_draws, poisson_cdf
from tests.torch_deadline import deadline  # noqa: F401

ATOL = 1e-6
N_BOOT = 5
CPU = {"device": "cpu"}


def close(got, want, atol: float = ATOL) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            close(got[key], want[key], atol)
        return
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)


def mc_batches(seed: int, n: int = 64, count: int = 3, classes: int = 4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        target = rng.integers(0, classes, n)
        out.append((np.where(rng.random(n) < 0.6, target, rng.integers(0, classes, n)), target))
    return out


def bin_batches(seed: int, n: int = 64, count: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        target = rng.integers(0, 2, n)
        out.append((np.round(np.clip(rng.random(n) * 0.7 + 0.3 * target, 0, 1), 2).astype(np.float32), target))
    return out


def jax_draws(key, size: int):
    """The uniforms and pads ``_device_sample`` draws from ``key``, drawn here."""
    k_cnt, k_pad = jax.random.split(key)
    u = jax.random.uniform(k_cnt, (size,))
    pad = jax.random.randint(k_pad, (size,), 0, size)
    return torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(pad)).to(torch.int64)


def stacked_indices(jax_boot, rng, size: int) -> torch.Tensor:
    """One JAX stacked update's indices, replayed from its host seed stream."""
    seed = int(rng.integers(0, 2**63 - 1))
    keys = jax.random.split(jax.random.PRNGKey(seed), jax_boot.num_bootstraps)
    return torch.from_numpy(np.stack([np.asarray(jax_boot._device_sample(k, size)) for k in keys])).to(torch.int64)


def pure_indices(jax_boot, key, size: int):
    """One JAX pure-tier update's indices and the key it leaves behind."""
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, jax_boot.num_bootstraps)
    idx = np.stack([np.asarray(jax_boot._device_sample(k, size)) for k in keys])
    return key, torch.from_numpy(idx).to(torch.int64)


# ------------------------------------------------------------------- sampler


def test_poisson_cdf_table_is_bit_equal_to_jax():
    ks = jnp.arange(17)
    want = np.asarray(jnp.cumsum(jnp.exp(-1.0 - jax.scipy.special.gammaln(ks + 1.0))))
    got = poisson_cdf().numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("size", [1, 2, 7, 64, 256])
def test_indices_from_draws_equal_jax_device_sample(strategy, size):
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(3), 2, sampling_strategy=strategy)
    port = tw.BootStrapper(tc.MulticlassAccuracy(3, **CPU), 2, sampling_strategy=strategy)
    truncated = padded = 0
    rows_u, rows_pad, wants = [], [], []
    for s in range(12):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jax_boot._device_sample(key, size))
        if strategy == "multinomial":
            draw = torch.from_numpy(np.asarray(jax.random.randint(key, (size,), 0, size))).to(torch.int64)
            got = port._indices((draw,), size)
        else:
            u, pad = jax_draws(key, size)
            got = _indices_from_draws(u, pad, size)
            total = int((u.unsqueeze(-1) > poisson_cdf()).sum())
            truncated += total > size
            padded += total < size
            rows_u.append(u)
            rows_pad.append(pad)
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        wants.append(want)
    if strategy == "poisson":
        if size >= 7:
            assert truncated and padded  # both edges of the static length were met
        batched = _indices_from_draws(torch.stack(rows_u), torch.stack(rows_pad), size)
        assert np.array_equal(batched.numpy(), np.stack(wants).astype(np.int64))


# ------------------------------------------------------------ stacked eager


@pytest.mark.parametrize("average", ["micro", "macro"])
@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_stacked_update_bit_equal_to_jax_through_the_seam(average, strategy):
    kwargs = dict(num_bootstraps=N_BOOT, quantile=np.asarray([0.1, 0.9]), raw=True, sampling_strategy=strategy,
                  seed=21)
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(4, average=average), **kwargs)
    port = tw.BootStrapper(tc.MulticlassAccuracy(4, average=average, **CPU), **kwargs)
    rng = np.random.default_rng(21)
    for p, t in mc_batches(4):
        indices = stacked_indices(jax_boot, rng, len(p))
        jax_boot.update(jnp.asarray(p), jnp.asarray(t))
        port._stacked_update_with_indices(indices, torch.tensor(p), torch.tensor(t))
    for name in ("tp", "fp", "tn", "fn"):
        want = np.asarray(getattr(jax_boot, f"boot_{name}")).astype(np.int64)
        assert np.array_equal(getattr(port, f"boot_{name}").numpy(), want)
    close(port.compute(), jax_boot.compute())


def test_stacked_update_draws_replay_into_base_metrics():
    """``update``'s own draws: one seed a step from the host stream, a generator on the
    metric's device, the JAX transform; replayed into JAX base metrics."""
    port = tw.BootStrapper(tc.MulticlassAccuracy(4, average="macro", **CPU), N_BOOT, seed=9, raw=True)
    twin = tw.BootStrapper(tc.MulticlassAccuracy(4, average="macro", **CPU), N_BOOT, seed=9, raw=True)
    bases = [jc.MulticlassAccuracy(4, average="macro") for _ in range(N_BOOT)]
    rng = np.random.default_rng(9)
    for p, t in mc_batches(5):
        port.update(torch.tensor(p), torch.tensor(t))
        twin.update(torch.tensor(p), torch.tensor(t))
        idx = port._indices(port._device_draws(int(rng.integers(0, 2**63 - 1)), len(p)), len(p)).numpy()
        for base, rows in zip(bases, idx):
            base.update(jnp.asarray(p[rows]), jnp.asarray(t[rows]))
    close(port.compute()["raw"], jnp.stack([b.compute() for b in bases]))
    assert torch.equal(port.boot_tp, twin.boot_tp)  # a seed replays
    assert len(port.metrics) == 1 and int(port.metrics[0]._update_count) == 0  # the template stays fresh


# ------------------------------------------------------------------ pure tier


@pytest.mark.parametrize("average", ["micro", "macro"])
def test_pure_tier_matches_jax_pure_tier(average):
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(4, average=average), N_BOOT, seed=2, raw=True)
    port = tw.BootStrapper(tc.MulticlassAccuracy(4, average=average, **CPU), N_BOOT, seed=2, raw=True)
    js, ts = jax_boot.init_state(), port.init_state()
    assert int(ts["seed"]) == 2 and ts["metrics"]["tp"].shape == np.asarray(js["metrics"]["tp"]).shape
    key = js["key"]
    for p, t in mc_batches(6):
        key, idx = pure_indices(jax_boot, key, len(p))
        js = jax_boot.local_update(js, jnp.asarray(p), jnp.asarray(t))
        ts = port._local_update_with_indices(ts, idx, torch.tensor(p), torch.tensor(t))
    for name, want in js["metrics"].items():
        assert np.array_equal(ts["metrics"][name].numpy(), np.asarray(want).astype(np.int64))
    close(port.compute_from(ts), jax_boot.compute_from(js))


@pytest.mark.parametrize("capacity", [256, 100])
def test_pure_tier_cat_buffer_base_matches_jax(capacity):
    """BinaryAUROC(cat_capacity): every copy appends ``size`` rows, so one host count
    serves the stack; at capacity 100 the third update overflows and poisons to NaN."""
    jax_boot = jw.BootStrapper(jc.BinaryAUROC(cat_capacity=capacity), N_BOOT, seed=4, raw=True, quantile=0.5)
    port = tw.BootStrapper(tc.BinaryAUROC(cat_capacity=capacity, **CPU), N_BOOT, seed=4, raw=True, quantile=0.5)
    js, ts = jax_boot.init_state(), port.init_state()
    key = js["key"]
    for p, t in bin_batches(7, n=48):
        key, idx = pure_indices(jax_boot, key, len(p))
        js = jax_boot.local_update(js, jnp.asarray(p), jnp.asarray(t))
        ts = port._local_update_with_indices(ts, idx, torch.tensor(p), torch.tensor(t))
    buf = ts["metrics"]["preds"]
    assert buf.data.shape == (N_BOOT, capacity) and buf._count == 144 and buf.overflowed() == (capacity < 144)
    jax_data = np.asarray(js["metrics"]["preds"].data)
    if capacity >= 144:
        assert np.array_equal(buf.data.numpy(), jax_data)
    got, want = port.compute_from(ts), jax_boot.compute_from(js)
    close(got, want)
    assert bool(torch.isnan(got["raw"]).all()) == (capacity < 144)
    if capacity >= 144:  # each copy's value is its own eager compute on its rows
        for k in range(N_BOOT):
            one = tc.BinaryAUROC(**CPU)
            one.update(buf.data[k, :144], ts["metrics"]["target"].data[k, :144])
            close(got["raw"][k], one.compute())


def test_pure_tier_seed_replays_and_advances():
    port = tw.BootStrapper(tc.MulticlassAccuracy(4, **CPU), N_BOOT, seed=5, raw=True)
    p, t = (torch.tensor(x) for x in mc_batches(8)[0])
    state = port.init_state()
    a, b = port.local_update(state, p, t), port.local_update(state, p, t)
    assert torch.equal(a["metrics"]["tp"], b["metrics"]["tp"]) and int(a["seed"]) != int(state["seed"])
    c = port.local_update(a, p, t)
    assert not torch.equal(c["metrics"]["tp"] - a["metrics"]["tp"], a["metrics"]["tp"])  # other draws
    assert int(state["seed"]) == 5 and int(state["metrics"]["tp"].sum()) == 0  # the input state is kept
    unseeded = tw.BootStrapper(tc.MulticlassAccuracy(4, **CPU), N_BOOT)
    assert int(unseeded.init_state()["seed"]) != int(unseeded.init_state()["seed"])
    # without a group evaluate_sharded is the local loop, then compute_from
    batches = [tuple(torch.tensor(x) for x in b) for b in mc_batches(8)]
    state = port.init_state()
    for batch in batches:
        state = port.local_update(state, *batch)
    close(evaluate_sharded(port, batches), port.compute_from(state))


def test_pure_tier_guards_keep_the_jax_messages():
    for jax_wrapper, port_wrapper in (
        (jw.BootStrapper(jc.BinaryAUROC(), 3), tw.BootStrapper(tc.BinaryAUROC(**CPU), 3)),
        (jw.MultioutputWrapper(jreg.SpearmanCorrCoef(), 2), tw.MultioutputWrapper(treg.SpearmanCorrCoef(**CPU), 2)),
    ):
        with pytest.raises(ValueError) as want:
            jax_wrapper.init_state()
        with pytest.raises(ValueError) as got:
            port_wrapper.init_state()
        assert str(got.value) == str(want.value)
    jax_boot = jw.BootStrapper(jc.BinaryAUROC(cat_capacity=64), 3)
    port = tw.BootStrapper(tc.BinaryAUROC(cat_capacity=64, **CPU), 3)
    with pytest.raises(NotImplementedError) as want:
        jax_boot.sync_state(jax_boot.init_state(), "data")
    with pytest.raises(NotImplementedError) as got:
        port.sync_state(port.init_state(), None)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ fleet_size


def test_bootstrapper_fleet_routed_bit_equal_to_jax_and_broadcast_shapes():
    kwargs = dict(num_bootstraps=N_BOOT, quantile=0.5, raw=True, seed=0)
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(4, average="macro"), fleet_size=3, **kwargs)
    port = tw.BootStrapper(tc.MulticlassAccuracy(4, average="macro", **CPU), fleet_size=3, **kwargs)
    assert {k: tuple(v.shape) for k, v in port._defaults.items()} == {k: v.shape for k, v in jax_boot._defaults.items()}
    rng = np.random.default_rng(1)
    for p, t in mc_batches(10, n=40):
        ids = rng.integers(0, 3, len(p))
        jax_boot.update(jnp.asarray(p), jnp.asarray(t), stream_ids=jnp.asarray(ids))
        port.update(torch.tensor(p), torch.tensor(t), stream_ids=torch.tensor(ids))
    for name in ("tp", "fp", "tn", "fn"):
        assert np.array_equal(getattr(port, f"boot_{name}").numpy(),
                              np.asarray(getattr(jax_boot, f"boot_{name}")).astype(np.int64))
    got, want = port.compute(), jax_boot.compute()
    close(got, want)
    assert got["mean"].shape == (3,) and got["raw"].shape == (3, N_BOOT)
    close(port.compute(stream=1), {k: v[1] for k, v in want.items()})
    # without stream_ids every stream resamples the batch alike, as in the JAX package
    bcast = tw.BootStrapper(tc.MulticlassAccuracy(4, average="macro", **CPU), fleet_size=2, **kwargs)
    for p, t in mc_batches(11):
        bcast.update(torch.tensor(p), torch.tensor(t))
    assert bcast.boot_tp.shape == (2, N_BOOT, 4) and torch.equal(bcast.boot_tp[0], bcast.boot_tp[1])
    assert bcast.compute()["std"].shape == (2,) and float(bcast.compute()["std"][0]) > 0
    with pytest.raises(MetricsUserError, match="fleet"):
        tw.BootStrapper(tc.BinaryAUROC(**CPU), 3, fleet_size=2)  # nothing stacked to route


@pytest.mark.parametrize("labels", [None, ["a", "b", "c"]])
def test_classwise_over_a_fleet_inner_metric_bit_equal_to_jax(labels):
    jax_cw = jw.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=3, average=None, fleet_size=2), labels=labels)
    port = tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=3, average=None, fleet_size=2, **CPU), labels=labels)
    refs = [tc.MulticlassAccuracy(num_classes=3, average=None, **CPU) for _ in range(2)]
    rng = np.random.default_rng(5)
    for p, t in mc_batches(12, n=24, classes=3):
        ids = rng.integers(0, 2, len(p))
        jax_cw.update(jnp.asarray(p), jnp.asarray(t), stream_ids=jnp.asarray(ids))
        port.update(torch.tensor(p), torch.tensor(t), stream_ids=torch.tensor(ids))
        for s, ref in enumerate(refs):
            ref.update(torch.tensor(p[ids == s]), torch.tensor(t[ids == s]))
    got, want = port.compute(), jax_cw.compute()
    assert list(got) == list(want)
    for i, key in enumerate(want):
        assert got[key].shape == (2,)
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
        for s, ref in enumerate(refs):
            assert torch.equal(got[key][s], ref.compute()[i])


def test_minmax_takes_fleet_size_as_jax_does():
    jax_mm = jw.MinMaxMetric(jc.MulticlassAccuracy(3), fleet_size=2)
    port = tw.MinMaxMetric(tc.MulticlassAccuracy(3, **CPU), fleet_size=2)
    assert {k: tuple(v.shape) for k, v in port._defaults.items()} == {k: v.shape for k, v in jax_mm._defaults.items()}
    assert port._reductions["min_val"] == "min" and port._reductions["max_val"] == "max"
    # every update reaches the shared base once; each stream's min and max follow its computes
    base, values = tc.MulticlassAccuracy(3, **CPU), []
    for p, t in mc_batches(13, classes=3, count=4):
        port.update(torch.tensor(p), torch.tensor(t))
        base.update(torch.tensor(p), torch.tensor(t))
        out, want = port.compute(), base.compute()
        values.append(want)
        assert torch.equal(out["raw"], want.expand(2)) and out["max"].shape == out["min"].shape == (2,)
        assert torch.equal(out["max"], torch.stack(values).max().expand(2))
        assert torch.equal(out["min"], torch.stack(values).min().expand(2))
    with pytest.raises(MetricsUserError, match="stream_ids"):
        port.update(torch.tensor(p), torch.tensor(t), stream_ids=torch.zeros(len(p), dtype=torch.int64))


def test_multioutput_refuses_fleet_size_with_the_jax_message():
    with pytest.raises(JaxMetricsUserError) as want:
        jw.MultioutputWrapper(jreg.MeanSquaredError(), 2, fleet_size=2)
    with pytest.raises(MetricsUserError) as got:
        tw.MultioutputWrapper(treg.MeanSquaredError(**CPU), 2, fleet_size=2)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- MultioutputWrapper


def mo_batches(count: int = 3, n: int = 16, k: int = 2):
    rng = np.random.RandomState(0)
    return [(rng.rand(n, k).astype(np.float32), rng.rand(n, k).astype(np.float32)) for _ in range(count)]


@pytest.mark.parametrize("squeeze", [True, False])
@pytest.mark.parametrize("base", ["MeanSquaredError", "PearsonCorrCoef"])
def test_multioutput_pure_tier_matches_jax(squeeze, base):
    kwargs = dict(num_outputs=2, remove_nans=False, squeeze_outputs=squeeze)
    jax_wrapper = jw.MultioutputWrapper(getattr(jreg, base)(), **kwargs)
    port = tw.MultioutputWrapper(getattr(treg, base)(**CPU), **kwargs)
    js, ts = jax_wrapper.init_state(), port.init_state()
    update = jax.jit(jax_wrapper.local_update)
    for p, t in mo_batches():
        js = update(js, jnp.asarray(p), jnp.asarray(t))
        ts = port.local_update(ts, torch.tensor(p), torch.tensor(t))
    for name, want in js.items():
        close(ts[name], want, atol=1e-5)
    got = port.compute_from(ts)
    close(got, jax_wrapper.compute_from(js))
    eager = tw.MultioutputWrapper(getattr(treg, base)(**CPU), **kwargs)
    for p, t in mo_batches():
        eager.update(torch.tensor(p), torch.tensor(t))
    close(got, eager.compute())
    assert got.shape == (2,)


def test_multioutput_pure_remove_nans_errors():
    p, t = mo_batches(1)[0]
    port = tw.MultioutputWrapper(treg.MeanSquaredError(**CPU), 2)  # remove_nans by default
    with pytest.raises(NotImplementedError, match="remove_nans"):
        port.local_update(port.init_state(), torch.tensor(p), torch.tensor(t))
    jax_wrapper = jw.MultioutputWrapper(jreg.MeanSquaredError(), 2)
    with pytest.raises(ValueError) as want:
        jax.jit(lambda a, b: jax_wrapper._get_args_kwargs_by_output(a, b))(jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(ValueError) as got:  # a traced update filters nothing: the JAX error
        torch.func.vmap(lambda a, b: port._get_args_kwargs_by_output(a, b))(torch.tensor(p)[None], torch.tensor(t)[None])
    assert str(got.value) == str(want.value)
