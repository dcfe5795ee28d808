"""The wrappers of metrics_tpu_torch against metrics_tpu, on the CPU.

Seeded numpy inputs go through the JAX package's wrappers and the port's
(``device="cpu"``): the five wrappers over three updates, ``forward``, ``reset`` and
``compute``, within 1e-6.

- BootStrapper on a list-state base (``BinaryAUROC``, the JAX copies path): each
  copy's states are bit-equal to the JAX copy's under the same seed. On a base both
  packages stack (``MulticlassAccuracy``) the JAX stacked path's ``jax.random``
  indices are replayed and fed through the port's seam
  (``_stacked_update_with_indices``): the stacked counts are bit-equal; a JAX stacked
  state loads into the port's ``boot_<name>`` states, and a pure-tier state is refused.
- ``forward`` of BootStrapper and MinMaxMetric keeps the children's accumulated
  state: the accumulated ``compute`` equals a JAX wrapper fed both batches through
  ``update`` and the batch value equals the JAX ``forward``'s (the JAX wrappers'
  ``forward`` resets their children, a fault of the reference).
- ClasswiseWrapper and MultioutputWrapper compute afresh after ``forward``, where the
  JAX package returns the value cached before it (a fault of the reference).
- MultioutputWrapper with NaN rows; MetricTracker over the ported
  ``MetricCollection``, NaN in ``best_metric`` as ``argmax``/``argmin`` take it.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.classification as jc
import metrics_tpu.regression as jreg
import metrics_tpu.wrappers as jw
import metrics_tpu_torch
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.regression as treg
import metrics_tpu_torch.wrappers as tw
from metrics_tpu.core.collections import MetricCollection as JaxCollection
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as jax_bootstrap_sampler
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core.collections import MetricCollection

ATOL = 1e-6
N_BOOT = 4


def assert_close(got, want, atol: float = ATOL) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            assert_close(got[key], want[key], atol)
        return
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def multiclass_batches(seed: int, n: int = 40, count: int = 4, classes: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        target = rng.integers(0, classes, n)
        preds = np.where(rng.random(n) < 0.6, target, rng.integers(0, classes, n))
        out.append((preds, target))
    return out


def binary_batches(seed: int, n: int = 30, count: int = 4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        target = rng.integers(0, 2, n)
        out.append((np.round(np.clip(rng.random(n) * 0.7 + 0.3 * target, 0, 1), 2).astype(np.float32), target))
    return out


def jax_args(batch):
    return tuple(jnp.asarray(x) for x in batch)


def port_args(batch):
    return tuple(torch.tensor(x) for x in batch)


# -------------------------------------------------------------- BootStrapper


def test_bootstrapper_list_state_copies_bit_equal_to_jax_copies_path():
    kwargs = dict(num_bootstraps=N_BOOT, quantile=np.asarray([0.05, 0.95]), raw=True, seed=3)
    jax_boot = jw.BootStrapper(jc.BinaryAUROC(), **kwargs)
    port = tw.BootStrapper(tc.BinaryAUROC(device="cpu"), **kwargs)
    assert not jax_boot._eager_stacked
    for batch in binary_batches(1)[:3]:
        jax_boot.update(*jax_args(batch))
        port.update(*port_args(batch))
    for jax_copy, copy in zip(jax_boot.metrics, port.metrics):
        for name in ("preds", "target"):
            want, got = getattr(jax_copy, name), getattr(copy, name)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))
    assert_close(port.compute(), jax_boot.compute())


def jax_stacked_indices(jax_boot, rng, size: int):
    """The indices of one JAX stacked update, replayed: the seed it takes from its host
    stream, the keys it splits, and ``_device_sample`` of each key."""
    import jax

    seed = int(rng.integers(0, 2**63 - 1))
    keys = jax.random.split(jax.random.PRNGKey(seed), jax_boot.num_bootstraps)
    return np.stack([np.asarray(jax_boot._device_sample(k, size)) for k in keys])


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_stackable_base_against_jax_bases_fed_the_same_indices(strategy):
    """The JAX stacked path's indices, replayed and fed through the port's seam: the
    stacked counts are bit-equal to the JAX wrapper's."""
    kwargs = dict(num_bootstraps=N_BOOT, quantile=0.5, raw=True, sampling_strategy=strategy, seed=5)
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(3, average="macro"), **kwargs)
    port = tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"), **kwargs)
    assert jax_boot._eager_stacked and port._eager_stacked and len(port.metrics) == 1
    rng = np.random.default_rng(5)
    for batch in multiclass_batches(2)[:3]:
        indices = jax_stacked_indices(jax_boot, rng, len(batch[0]))
        jax_boot.update(*jax_args(batch))
        port._stacked_update_with_indices(torch.from_numpy(indices), *port_args(batch))
    for name in ("tp", "fp", "tn", "fn"):
        want = np.asarray(getattr(jax_boot, f"boot_{name}"))
        got = getattr(port, f"boot_{name}").numpy()
        assert got.shape == want.shape == (N_BOOT, 3)
        assert np.array_equal(got, want.astype(np.int64))
    assert_close(port.compute(), jax_boot.compute())


def test_bootstrapper_loads_a_jax_stacked_state():
    quantile = np.asarray([0.25, 0.75])
    jax_boot = jw.BootStrapper(jc.MulticlassAccuracy(3, average="macro"), num_bootstraps=N_BOOT,
                               quantile=quantile, seed=7)
    assert jax_boot._eager_stacked
    for batch in multiclass_batches(3)[:3]:
        jax_boot.update(*jax_args(batch))
    jax_boot.persistent(True)
    state = jax_boot.state_dict()
    assert set(state) == {"boot_tp", "boot_fp", "boot_tn", "boot_fn"}
    port = load_jax_state(tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"),
                                          num_bootstraps=N_BOOT, quantile=quantile), state)
    for name in ("tp", "fp", "tn", "fn"):  # into the port's own stacked states
        assert np.array_equal(getattr(port, f"boot_{name}").numpy(), np.asarray(state[f"boot_{name}"]).astype(np.int64))
    assert_close(port.compute(), jax_boot.compute())
    with pytest.raises(ValueError, match="rows"):
        load_jax_state(tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"), num_bootstraps=3),
                       state)
    with pytest.raises(KeyError, match="boot_"):
        load_jax_state(tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu")), {})
    # a pure-tier state carries a jax.random key: refused with the reason
    pure = jax_boot.init_state()
    with pytest.raises(ValueError, match="jax.random key"):
        load_jax_state(tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"),
                                       num_bootstraps=N_BOOT), pure)


def test_bootstrapper_forward_keeps_the_copies_state_list_base():
    """List-state base (the JAX copies path, the same draws): update(b1), forward(b2)."""
    b1, b2 = binary_batches(4)[:2]
    kwargs = dict(num_bootstraps=N_BOOT, raw=True, seed=11)
    port = tw.BootStrapper(tc.BinaryAUROC(device="cpu"), **kwargs)
    jax_forward = jw.BootStrapper(jc.BinaryAUROC(), **kwargs)
    port.update(*port_args(b1))
    jax_forward.update(*jax_args(b1))
    assert_close(port(*port_args(b2)), jax_forward(*jax_args(b2)))
    # the JAX wrapper's copies lost b1 in its forward; one fed b1 and b2 by update has both
    assert all(len(m.preds) == 1 for m in jax_forward.metrics)
    jax_updates = jw.BootStrapper(jc.BinaryAUROC(), **kwargs)
    jax_updates.update(*jax_args(b1))
    jax_updates.update(*jax_args(b2))
    assert all(len(m.preds) == 2 for m in port.metrics)
    assert_close(port.compute(), jax_updates.compute())


def test_bootstrapper_forward_keeps_the_copies_state_stackable_base():
    """Stacked base: update(b1), forward(b2). The port's own draws (one seed a step from
    its host stream) are replayed into JAX bases: the batch value and the accumulated
    value equal theirs, so forward kept the stacked state."""
    b1, b2 = multiclass_batches(5)[:2]
    port = tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"), num_bootstraps=N_BOOT,
                           raw=True, seed=13)
    replay = tw.BootStrapper(tc.MulticlassAccuracy(3, average="macro", device="cpu"), num_bootstraps=N_BOOT)
    rng = np.random.default_rng(13)
    size = len(b1[0])
    d1, d2, d3 = (replay._indices(replay._device_draws(int(rng.integers(0, 2**63 - 1)), size), size).numpy()
                  for _ in range(3))

    def jax_values(draws_and_batches):
        bases = [jc.MulticlassAccuracy(3, average="macro") for _ in range(N_BOOT)]
        for draws, batch in draws_and_batches:
            for base, idx in zip(bases, draws):
                base.update(*(jnp.asarray(x[idx]) for x in batch))
        return jnp.stack([base.compute() for base in bases])

    port.update(*port_args(b1))
    batch_value = port(*port_args(b2))
    assert_close(batch_value["raw"], jax_values([(d3, b2)]))
    assert_close(port.compute()["raw"], jax_values([(d1, b1), (d2, b2)]))


def test_bootstrapper_reset_compute_and_arguments():
    port = tw.BootStrapper(tc.MulticlassAccuracy(3, device="cpu"), num_bootstraps=N_BOOT, seed=0)
    for batch in multiclass_batches(6)[:3]:
        port.update(*port_args(batch))
    assert int(port.boot_tp.sum()) > 0
    port.reset()
    assert all(int(getattr(port, f"boot_{name}").sum()) == 0 for name in ("tp", "fp", "tn", "fn"))
    with pytest.raises(ValueError, match="instance of metrics_tpu_torch.Metric"):
        tw.BootStrapper(object())
    with pytest.raises(ValueError, match="sampling_strategy"):
        tw.BootStrapper(tc.MulticlassAccuracy(3, device="cpu"), sampling_strategy="jackknife")
    # fleet_size is taken as the JAX wrapper takes it: the stack under the stream axis
    fleet = tw.BootStrapper(tc.MulticlassAccuracy(3, device="cpu"), num_bootstraps=N_BOOT, fleet_size=2)
    want = jw.BootStrapper(jc.MulticlassAccuracy(3), num_bootstraps=N_BOOT, fleet_size=2)
    assert {k: tuple(v.shape) for k, v in fleet._defaults.items()} == {k: v.shape for k, v in want._defaults.items()}
    with pytest.raises(ValueError, match="could not determine the sampling size"):
        port.update(3)


def test_wrappers_live_on_the_base_metrics_device():
    base = tc.MulticlassAccuracy(3, device="cpu")
    for make in (lambda **kw: tw.BootStrapper(base, **kw), lambda **kw: tw.MinMaxMetric(base, **kw),
                 lambda **kw: tw.MultioutputWrapper(base, 2, **kw)):
        assert make().device == base.device == make(device="cpu").device
        with pytest.raises(ValueError, match="differs from the base metric's device"):
            make(device="cuda")
    boot = tw.BootStrapper(base, num_bootstraps=2)
    assert isinstance(boot.metrics, torch.nn.ModuleList) and len(list(boot.children())) == 1
    assert boot.to("cpu").device == torch.device("cpu") and tw.ClasswiseWrapper(base).device == base.device


# ---------------------------------------------------------------- MinMax


def test_minmax_three_updates_forward_reset_and_compute():
    batches = multiclass_batches(7)
    jax_metric = jw.MinMaxMetric(jc.MulticlassAccuracy(3, average="macro"))
    port = tw.MinMaxMetric(tc.MulticlassAccuracy(3, average="macro", device="cpu"))
    for batch in batches[:3]:
        jax_metric.update(*jax_args(batch))
        port.update(*port_args(batch))
        assert_close(port.compute(), jax_metric.compute())  # the running min and max move
    # forward: the batch value equals JAX's; the base keeps all four batches (the JAX base only the last)
    jax_updates = jc.MulticlassAccuracy(3, average="macro")
    for batch in batches:
        jax_updates.update(*jax_args(batch))
    assert_close(port(*port_args(batches[3])), jax_metric(*jax_args(batches[3])))
    got = port.compute()
    assert_close(got["raw"], jax_updates.compute())
    assert int(port._base_metric.tp.sum() + port._base_metric.fn.sum()) == 4 * len(batches[0][1])
    assert int(np.asarray(jax_metric._base_metric.tp).sum() + np.asarray(jax_metric._base_metric.fn).sum()) == len(
        batches[0][1])
    port.reset()
    assert float(port.min_val) == float("inf") and int(port._base_metric.tp.sum()) == 0
    with pytest.raises(ValueError, match="instance of `metrics_tpu_torch.Metric`"):
        tw.MinMaxMetric(3)


def test_minmax_refuses_a_non_scalar_base_value():
    port = tw.MinMaxMetric(tc.MulticlassAccuracy(3, average=None, device="cpu"))
    port.update(*port_args(multiclass_batches(8)[0]))
    with pytest.raises(RuntimeError, match="float or scalar tensor"):
        port.compute()


# -------------------------------------------------------------- Classwise


@pytest.mark.parametrize("labels", [None, ["cat", "dog", "bird"]])
def test_classwise_three_updates_forward_reset_and_compute(labels):
    batches = multiclass_batches(9)
    jax_metric = jw.ClasswiseWrapper(jc.MulticlassAccuracy(3, average=None), labels=labels)
    port = tw.ClasswiseWrapper(tc.MulticlassAccuracy(3, average=None, device="cpu"), labels=labels)
    for batch in batches[:3]:
        jax_metric.update(*jax_args(batch))
        port.update(*port_args(batch))
    assert_close(port.compute(), jax_metric.compute())
    assert_close(port(*port_args(batches[3])), jax_metric(*jax_args(batches[3])))
    # after forward the port computes afresh; the JAX wrapper returns its cached value
    fresh = jax_metric._convert(jax_metric.metric.compute())
    assert_close(port.compute(), fresh)
    stale = jax_metric.compute()
    assert not np.allclose([float(v) for v in stale.values()], [float(v) for v in fresh.values()])
    port.reset()
    assert int(port.metric.tp.sum()) == 0
    with pytest.raises(ValueError, match="list of strings"):
        tw.ClasswiseWrapper(tc.MulticlassAccuracy(3, average=None, device="cpu"), labels="abc")


# ------------------------------------------------------------ Multioutput


def regression_rows(seed: int, n: int = 24, outputs: int = 3, nan_rate: float = 0.1):
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((n, outputs)).astype(np.float32)
    target = (preds + 0.5 * rng.standard_normal((n, outputs))).astype(np.float32)
    preds[rng.random((n, outputs)) < nan_rate] = np.nan
    target[rng.random((n, outputs)) < nan_rate] = np.nan
    return preds, target


@pytest.mark.parametrize("base", ["MeanSquaredError", "PearsonCorrCoef"])
def test_multioutput_with_nan_rows_three_updates_forward_reset_and_compute(base):
    batches = [regression_rows(20 + k) for k in range(4)]
    jax_metric = jw.MultioutputWrapper(getattr(jreg, base)(), num_outputs=3)
    port = tw.MultioutputWrapper(getattr(treg, base)(device="cpu"), num_outputs=3)
    for batch in batches[:3]:
        jax_metric.update(*jax_args(batch))
        port.update(*port_args(batch))
    assert_close(port.compute(), jax_metric.compute(), atol=1e-5)
    assert_close(port(*port_args(batches[3])), jax_metric(*jax_args(batches[3])), atol=1e-5)
    want = jnp.stack([jnp.asarray(m.compute()) for m in jax_metric.metrics])  # the children, computed afresh
    assert_close(port.compute(), want, atol=1e-5)
    # each output saw only its NaN-free rows
    rows = sum(int((~np.isnan(p[:, 1]) & ~np.isnan(t[:, 1])).sum()) for p, t in batches)
    if base == "MeanSquaredError":
        assert int(port.metrics[1].total) == rows
    port.reset()
    assert port.metrics[0]._update_count == 0


def test_multioutput_keeps_outputs_unsqueezed_and_along_dim_0():
    rng = np.random.default_rng(30)
    preds, target = rng.standard_normal((2, 10)).astype(np.float32), rng.standard_normal((2, 10)).astype(np.float32)
    for kwargs in ({"output_dim": 0}, {"output_dim": 0, "squeeze_outputs": False, "remove_nans": False}):
        jax_metric = jw.MultioutputWrapper(jreg.MeanSquaredError(), num_outputs=2, **kwargs)
        port = tw.MultioutputWrapper(treg.MeanSquaredError(device="cpu"), num_outputs=2, **kwargs)
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.tensor(preds), torch.tensor(target))
        assert_close(port.compute(), jax_metric.compute())


# --------------------------------------------------------------- Tracker


def collection_pair():
    kwargs = dict(num_classes=3, average="macro")
    jax_col = JaxCollection({"acc": jc.MulticlassAccuracy(**kwargs), "prec": jc.MulticlassPrecision(**kwargs)})
    port_col = MetricCollection({"acc": tc.MulticlassAccuracy(device="cpu", **kwargs),
                                 "prec": tc.MulticlassPrecision(device="cpu", **kwargs)})
    return jax_col, port_col


def test_tracker_over_a_collection_matches_jax():
    jax_col, port_col = collection_pair()
    jax_tracker, port = jw.MetricTracker(jax_col, maximize=[True, False]), tw.MetricTracker(port_col, [True, False])
    with pytest.raises(ValueError, match="increment"):
        port.update(*port_args(multiclass_batches(0)[0]))
    for step in range(3):
        jax_tracker.increment()
        port.increment()
        for batch in multiclass_batches(40 + step, count=2):
            jax_tracker.update(*jax_args(batch))
            port.update(*port_args(batch))
        assert_close(port.compute(), jax_tracker.compute())
    assert port.n_steps == jax_tracker.n_steps == 3
    assert_close(port.compute_all(), jax_tracker.compute_all())
    value, step = port.best_metric(return_step=True)
    want_value, want_step = jax_tracker.best_metric(return_step=True)
    assert step == want_step
    assert_close({k: np.float64(v) for k, v in value.items()}, want_value)
    batch = multiclass_batches(50)[0]
    assert_close(port(*port_args(batch)), jax_tracker(*jax_args(batch)))
    port.reset()
    port.reset_all()


@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_best_metric_with_nan_follows_jax(maximize):
    values = [np.asarray([0.5, 1.0], np.float32), np.asarray([np.nan, 1.0], np.float32),
              np.asarray([0.2, 0.4], np.float32)]
    jax_tracker = jw.MetricTracker(jreg.MeanSquaredError(), maximize=maximize)
    port = tw.MetricTracker(treg.MeanSquaredError(device="cpu"), maximize=maximize)
    for v in values:
        jax_tracker.increment()
        port.increment()
        jax_tracker.update(jnp.asarray(v), jnp.zeros(2))
        port.update(torch.tensor(v), torch.zeros(2))
    want_value, want_step = jax_tracker.best_metric(return_step=True)
    got_value, got_step = port.best_metric(return_step=True)
    assert got_step == want_step == 1 and np.isnan(got_value) and np.isnan(want_value)


def test_tracker_best_metric_of_a_collection_with_nan_follows_jax():
    """NaN in one member's values over the steps: its best is the NaN step in both packages,
    the other member's best is its own."""
    values = [np.asarray([0.5, 1.0], np.float32), np.asarray([np.nan, 1.0], np.float32),
              np.asarray([0.2, 0.4], np.float32)]
    jax_col = JaxCollection({"mse": jreg.MeanSquaredError(), "mae": jreg.MeanAbsoluteError()})
    port_col = MetricCollection({"mse": treg.MeanSquaredError(device="cpu"),
                                 "mae": treg.MeanAbsoluteError(device="cpu")})
    jax_tracker, port = jw.MetricTracker(jax_col, maximize=[True, False]), tw.MetricTracker(port_col, [True, False])
    for v in values:
        jax_tracker.increment()
        port.increment()
        jax_tracker.update(jnp.asarray(v), jnp.zeros(2))
        port.update(torch.tensor(v), torch.zeros(2))
    want_value, want_step = jax_tracker.best_metric(return_step=True)
    got_value, got_step = port.best_metric(return_step=True)
    assert got_step == want_step == {"mse": 1, "mae": 1}
    assert all(np.isnan(got_value[k]) and np.isnan(want_value[k]) for k in ("mse", "mae"))
    # without the NaN step each member's best is its own; ``maximize`` follows the
    # collection's key order (mae, mse) in both packages
    jax_tracker = jw.MetricTracker(jax_col, maximize=[True, False])
    port = tw.MetricTracker(port_col, [True, False])
    for v in values[::2]:
        jax_tracker.increment()
        port.increment()
        jax_tracker.update(jnp.asarray(v), jnp.zeros(2))
        port.update(torch.tensor(v), torch.zeros(2))
    want_value, want_step = jax_tracker.best_metric(return_step=True)
    got_value, got_step = port.best_metric(return_step=True)
    assert list(port_col) == ["mae", "mse"] and got_step == want_step == {"mae": 0, "mse": 1}
    assert_close({k: np.float64(v) for k, v in got_value.items()}, {k: np.float64(v) for k, v in want_value.items()})


def test_tracker_best_metric_of_a_per_class_value_warns_and_returns_none():
    jax_tracker = jw.MetricTracker(jc.MulticlassAccuracy(3, average=None))
    port = tw.MetricTracker(tc.MulticlassAccuracy(3, average=None, device="cpu"))
    for step in range(2):
        jax_tracker.increment()
        port.increment()
        batch = multiclass_batches(60 + step)[0]
        jax_tracker.update(*jax_args(batch))
        port.update(*port_args(batch))
    with pytest.warns(UserWarning, match="best"):
        assert jax_tracker.best_metric() is None
    with pytest.warns(UserWarning, match="best"):
        assert port.best_metric(return_step=True) == (None, None)
    with pytest.raises(TypeError):
        tw.MetricTracker(3)
    with pytest.raises(ValueError, match="single bool"):
        tw.MetricTracker(tc.MulticlassAccuracy(3, device="cpu"), maximize=[True])


def test_exports_match_jax():
    names = ["BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper"]
    assert sorted(tw.__all__) == sorted(jw.__all__) == names
    for name in names:
        assert getattr(metrics_tpu_torch, name) is getattr(tw, name) and hasattr(metrics_tpu, name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tw.MetricTracker(tc.MulticlassAccuracy(3, device="cpu"))
