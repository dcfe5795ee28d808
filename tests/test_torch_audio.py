"""The audio slice of metrics_tpu_torch against metrics_tpu, on the CPU.

The same numpy signals, drawn from seeded ``np.random.RandomState``s, go through the
JAX package and the port (``device="cpu"``):

- SNR, SI-SNR and SI-SDR within 1e-4 dB (the JAX package's own tolerance);
- SDR, which the port computes in float64 whatever the input dtype: within 1e-6 dB of
  the JAX package under ``jax.enable_x64(True)`` (float64 there too), and within the
  JAX package's own 5e-3 dB of its float32 default;
- SDR of a perfect or scaled estimate finite (156.5 dB, the clamped coherence: a
  deliberate deviation) through the functional, the class and PIT;
- PIT's best values and permutations for 2 and 3 speakers (the exhaustive table) and
  9 (scipy's linear sum assignment), ``pit_permutate``;
- STOI equal to the JAX package's numpy implementation, at 10 kHz and resampled;
- PESQ's error where the ``pesq`` package is missing;
- the classes over batches, the names and the root shims.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.audio as ja
import metrics_tpu.functional as jfr
import metrics_tpu.functional.audio as jf
import metrics_tpu_torch
import metrics_tpu_torch.audio as ta
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.audio as tf
from metrics_tpu_torch.utils import imports


def signals(seed: int, shape=(2, 400), noise: float = 0.3):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    preds = (target + noise * rng.randn(*shape)).astype(np.float32)
    return preds, target


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio"])
def test_snr_and_si_sdr_match_jax(name, zero_mean):
    preds, target = signals(1)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), zero_mean=zero_mean)
    got = getattr(tf, name)(preds, target, zero_mean=zero_mean, device="cpu")
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), atol=1e-4)


def test_si_snr_matches_jax():
    preds, target = signals(2, (3, 2, 300))
    want = jf.scale_invariant_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target))
    got = tf.scale_invariant_signal_noise_ratio(preds, target, device="cpu")
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), atol=1e-4)


SDR_CASES = [
    {"filter_length": 64},
    {"filter_length": 64, "zero_mean": True},
    {"filter_length": 128, "load_diag": 1e-3},
]


@pytest.mark.parametrize("kwargs", SDR_CASES, ids=str)
def test_sdr_matches_jax_in_float64_and_float32(kwargs):
    preds, target = signals(3, (2, 600), noise=0.5)
    with jax.enable_x64(True):
        want64 = jf.signal_distortion_ratio(jnp.asarray(preds, jnp.float64), jnp.asarray(target, jnp.float64), **kwargs)
        assert want64.dtype == jnp.float64
    got64 = tf.signal_distortion_ratio(preds.astype(np.float64), target.astype(np.float64), **kwargs, device="cpu")
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(as_numpy(got64), as_numpy(want64), rtol=0, atol=1e-6)
    want32 = jf.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got32 = tf.signal_distortion_ratio(preds, target, **kwargs, device="cpu")
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(as_numpy(got32), as_numpy(want32), rtol=0, atol=5e-3)
    # the float32 input computes in float64: the value is the float64 one, rounded
    np.testing.assert_allclose(as_numpy(got32), as_numpy(want64), rtol=1e-6, atol=1e-6)


#: SDR of a perfect or scaled estimate: the coherence clamped at 1 - eps (float64)
SDR_PERFECT_DB = 10 * np.log10((1 - np.finfo(np.float64).eps) / np.finfo(np.float64).eps)


@pytest.mark.parametrize("scale", [1.0, 0.5], ids=["equal", "half"])
def test_sdr_of_a_perfect_or_scaled_estimate_is_finite(scale):
    _, target = signals(6, (3, 800))
    preds = (scale * target).astype(np.float32)
    got = tf.signal_distortion_ratio(preds, target, filter_length=64, device="cpu")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), SDR_PERFECT_DB, rtol=1e-6)
    metric = ta.SignalDistortionRatio(filter_length=64, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert np.isfinite(float(metric.compute()))
    # PIT over two speakers: the perfect pairing wins, with a finite value
    pair = np.stack([target, target[::-1]], axis=1)
    best, perm = tf.permutation_invariant_training((scale * pair).astype(np.float32), pair,
                                                   tf.signal_distortion_ratio, "max", filter_length=64, device="cpu")
    assert torch.isfinite(best).all()
    np.testing.assert_array_equal(perm.numpy(), np.broadcast_to(np.arange(2), (3, 2)))
    pit = ta.PermutationInvariantTraining(tf.signal_distortion_ratio, "max", filter_length=64, device="cpu")
    pit.update(torch.from_numpy((scale * pair).astype(np.float32)), torch.from_numpy(pair))
    assert np.isfinite(float(pit.compute()))


def test_sdr_epoch_with_one_perfect_row_is_finite_and_matches_jax_on_the_noisy_rows():
    # 4 x 2 mixtures of 4,000 samples, row (0, 0) perfect. Under x64 the JAX package's
    # perfect row is inf, NaN or finite as its rounding of coh falls (on this seed
    # 159.5 dB: coh one ulp below 1); the port's clamp gives every such row 156.5 dB.
    # The epoch value is the JAX rows' mean with that row read as the port reads it.
    preds, target = signals(1, (4, 2, 4000))
    preds[0, 0] = target[0, 0]
    with jax.enable_x64(True):
        want_rows = np.asarray(jf.signal_distortion_ratio(jnp.asarray(preds, jnp.float64),
                                                          jnp.asarray(target, jnp.float64)))
    got_rows = tf.signal_distortion_ratio(preds, target, device="cpu").double().numpy()
    noisy = np.ones((4, 2), bool)
    noisy[0, 0] = False
    np.testing.assert_allclose(got_rows[noisy], want_rows[noisy], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_rows[0, 0], SDR_PERFECT_DB, rtol=1e-6)
    tmetric = ta.SignalDistortionRatio(device="cpu")
    tmetric.update(torch.from_numpy(preds), torch.from_numpy(target))
    got = float(tmetric.compute())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, np.where(noisy, want_rows, SDR_PERFECT_DB).mean(), rtol=1e-5)


def test_sdr_use_cg_iter_warns_as_in_jax():
    preds, target = signals(4, (1, 300))
    with pytest.warns(UserWarning, match="`use_cg_iter` is accepted for API parity but ignored"):
        tf.signal_distortion_ratio(preds, target, use_cg_iter=10, filter_length=32, device="cpu")


def _si_sdr_jax(p, t):
    return jf.scale_invariant_signal_distortion_ratio(p, t)


def _si_sdr_torch(p, t):
    return tf.scale_invariant_signal_distortion_ratio(p, t)


@pytest.mark.parametrize("spk,eval_func", [(2, "max"), (3, "max"), (3, "min"), (9, "max")])
def test_pit_matches_jax(spk, eval_func):
    rng = np.random.RandomState(spk)
    target = rng.randn(3, spk, 200).astype(np.float32)
    perm = np.stack([rng.permutation(spk) for _ in range(3)])
    preds = (np.take_along_axis(target, perm[:, :, None], axis=1) + 0.2 * rng.randn(3, spk, 200)).astype(np.float32)
    want_metric, want_perm = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), _si_sdr_jax,
                                                               eval_func)
    got_metric, got_perm = tf.permutation_invariant_training(preds, target, _si_sdr_torch, eval_func, device="cpu")
    np.testing.assert_allclose(as_numpy(got_metric), as_numpy(want_metric), atol=1e-4)
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    if eval_func == "max":
        np.testing.assert_array_equal(np.take_along_axis(perm, got_perm.numpy(), axis=1),
                                      np.broadcast_to(np.arange(spk), (3, spk)))
    got_permuted = tf.pit_permutate(torch.from_numpy(preds), got_perm)
    want_permuted = jf.pit_permutate(jnp.asarray(preds), want_perm)
    np.testing.assert_array_equal(got_permuted.numpy(), np.asarray(want_permuted))


def test_pit_without_scipy_raises_the_jax_error(monkeypatch):
    import metrics_tpu.functional.audio.pit as jpit

    preds = np.random.RandomState(0).randn(1, 9, 50).astype(np.float32)
    monkeypatch.setattr(jpit, "_SCIPY_AVAILABLE", False)
    monkeypatch.setattr(imports, "_SCIPY_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as jexc:
        jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(preds), _si_sdr_jax)
    with pytest.raises(ModuleNotFoundError) as texc:
        tf.permutation_invariant_training(preds, preds, _si_sdr_torch, device="cpu")
    assert str(texc.value) == str(jexc.value)


def test_pit_errors_match_jax():
    preds, target = signals(5, (2, 2, 50))
    for args in ((preds, target[:1]), (preds, target, "mean")):
        with pytest.raises(Exception) as jexc:
            jf.permutation_invariant_training(jnp.asarray(args[0]), jnp.asarray(args[1]), _si_sdr_jax, *args[2:])
        with pytest.raises(Exception) as texc:
            tf.permutation_invariant_training(args[0], args[1], _si_sdr_torch, *args[2:], device="cpu")
        assert type(texc.value) is type(jexc.value) and str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("fs,extended", [(10000, False), (10000, True), (8000, False)])
def test_stoi_equals_the_jax_numpy_port(fs, extended):
    rng = np.random.RandomState(fs)
    target = rng.randn(2, 6000)
    target[:, 2000:2600] *= 1e-4  # a stretch of silent frames
    preds = target + 0.4 * rng.randn(2, 6000)
    want = jf.short_time_objective_intelligibility(preds, target, fs, extended)
    got = tf.short_time_objective_intelligibility(preds, target, fs, extended, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stoi_short_signal_warns_and_returns_the_sentinel():
    with pytest.warns(RuntimeWarning, match="Signal too short for STOI"):
        got = tf.short_time_objective_intelligibility(np.ones(100), np.ones(100), 10000, device="cpu")
    assert float(got) == pytest.approx(1e-5)


def test_pesq_raises_the_jax_error_without_the_package():
    assert not imports._PESQ_AVAILABLE
    x = np.zeros(8000, np.float32)
    with pytest.raises(ModuleNotFoundError) as jexc:
        jf.perceptual_evaluation_speech_quality(jnp.asarray(x), jnp.asarray(x), 8000, "nb")
    with pytest.raises(ModuleNotFoundError) as texc:
        tf.perceptual_evaluation_speech_quality(x, x, 8000, "nb", device="cpu")
    assert str(texc.value) == str(jexc.value)
    with pytest.raises(ModuleNotFoundError) as jexc:
        ja.PerceptualEvaluationSpeechQuality(8000, "nb")
    with pytest.raises(ModuleNotFoundError) as texc:
        ta.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
    assert str(texc.value) == str(jexc.value)


# ---------------------------------------------------------------------- classes

CLASS_CASES = [
    ("SignalNoiseRatio", {}, {}),
    ("SignalNoiseRatio", {"zero_mean": True}, {}),
    ("ScaleInvariantSignalNoiseRatio", {}, {}),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, {}),
    ("SignalDistortionRatio", {"filter_length": 64}, {"x64": True}),
    ("PermutationInvariantTraining", {"eval_func": "max"}, {"pit": True}),
    ("ShortTimeObjectiveIntelligibility", {"fs": 10000}, {"long": True}),
]


@pytest.mark.parametrize("name,kwargs,how", CLASS_CASES, ids=lambda v: str(v))
def test_class_matches_jax(name, kwargs, how):
    shape = (2, 3000) if how.get("long") else ((2, 2, 300) if how.get("pit") else (2, 300))
    jargs = (_si_sdr_jax,) if how.get("pit") else ()
    targs = (_si_sdr_torch,) if how.get("pit") else ()
    jmetric = getattr(ja, name)(*jargs, **kwargs)
    tmetric = getattr(ta, name)(*targs, **kwargs, device="cpu")
    for k in range(3):
        preds, target = signals(10 + k, shape)
        if how.get("x64"):
            preds, target = preds.astype(np.float64), target.astype(np.float64)
            with jax.enable_x64(True):
                jmetric.update(jnp.asarray(preds), jnp.asarray(target))
        else:
            jmetric.update(jnp.asarray(preds), jnp.asarray(target))
        tmetric.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(as_numpy(tmetric.compute()), as_numpy(jmetric.compute()), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,kwargs", [
    ("SignalNoiseRatio", {"zero_mean": 1}), ("ScaleInvariantSignalDistortionRatio", {"zero_mean": None}),
    ("ShortTimeObjectiveIntelligibility", {"fs": -1}), ("PermutationInvariantTraining", {"eval_func": "mean"}),
])
def test_class_argument_errors_match_jax(name, kwargs):
    args = (_si_sdr_jax,) if name == "PermutationInvariantTraining" else ()
    with pytest.raises(Exception) as jexc:
        getattr(ja, name)(*args, **kwargs)
    with pytest.raises(Exception) as texc:
        getattr(ta, name)(*args, **kwargs, device="cpu")
    assert type(texc.value) is type(jexc.value) and str(texc.value) == str(jexc.value)


def test_pit_class_passes_other_kwargs_to_the_metric():
    preds, target = signals(20, (2, 2, 300))
    m = ta.PermutationInvariantTraining(tf.scale_invariant_signal_distortion_ratio, "max", zero_mean=True, device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, _ = jf.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target),
                                               jf.scale_invariant_signal_distortion_ratio, "max", zero_mean=True)
    np.testing.assert_allclose(float(m.compute()), float(jnp.mean(want)), atol=1e-4)


# ------------------------------------------------------------ names and shims


@pytest.mark.parametrize("module,port", [(ja, ta), (jf, tf)], ids=["audio", "functional.audio"])
def test_every_public_name_exists_in_the_port(module, port):
    assert set(port.__all__) == set(module.__all__)
    assert not [n for n in module.__all__ if not hasattr(port, n)]


def _warns(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return any(issubclass(w.category, FutureWarning) for w in caught)


@pytest.mark.parametrize("name", sorted(set(ja.__all__) - {"PerceptualEvaluationSpeechQuality"}))
def test_root_class_shims_warn_as_in_jax(name):
    args = (_si_sdr_torch,) if name == "PermutationInvariantTraining" else ()
    kwargs = {"fs": 10000} if name == "ShortTimeObjectiveIntelligibility" else {}
    assert (name in metrics_tpu.__all__) == (name in metrics_tpu_torch.__all__)
    jax_warns = _warns(lambda: getattr(metrics_tpu, name)(*args, **kwargs))
    assert _warns(lambda: getattr(metrics_tpu_torch, name)(*args, **kwargs, device="cpu")) == jax_warns
    assert not _warns(lambda: getattr(ta, name)(*args, **kwargs, device="cpu"))


@pytest.mark.parametrize("name", sorted(set(jf.__all__) - {"perceptual_evaluation_speech_quality"}))
def test_root_functional_shims_warn_as_in_jax(name):
    preds, target = signals(30, (1, 2, 3000))
    if name == "permutation_invariant_training":
        jargs, targs = (_si_sdr_jax,), (_si_sdr_torch,)
    elif name == "short_time_objective_intelligibility":
        jargs = targs = (10000,)
    else:
        jargs = targs = ()
    if name == "pit_permutate":
        target = np.array([[1, 0]])
    jax_warns = _warns(lambda: getattr(jfr, name)(jnp.asarray(preds), jnp.asarray(target), *jargs))
    assert _warns(lambda: getattr(tfr, name)(torch.from_numpy(preds), torch.from_numpy(target), *targs)) == jax_warns
    assert not _warns(lambda: getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), *targs))
