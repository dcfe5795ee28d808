"""The InceptionV3 and the inception metrics (FID, KID, IS) of metrics_tpu_torch
against metrics_tpu, on the CPU.

- The network: the same random weights (``random_inception_params(0)`` carried across
  with ``inception_state_from_jax``, and the port's own ``random_inception_state(0)``,
  which must be the same draws) through both forwards, every tap, on 2 images of
  299x299 (the resize is the identity) and 2 of 67x45 (the TF-1.x resize), within
  1e-3 absolute (the JAX package's own golden test allows 2e-3); the JAX side runs
  once per module. The port's bf16 path against its float32 path.
- FID, KID and IS with a small callable ``feature``, identical features in both
  packages: within 1e-5 relative; numpy's global state seeded alike, so KID's
  subsets and IS's permutation are the same draws.
- FID's stacked post-sync triples: the port's eager sync (an injected gather of three
  "ranks") and ``load_jax_state`` of a JAX-stacked triple, both against one process
  on the union.
- The weights file path (``METRICS_TPU_INCEPTION_WEIGHTS``) with an ``.npz`` the test
  writes, and its absence.

The checks on the card are in ``tests/test_torch_image_card.py``, which imports no JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import metrics_tpu.image as ji
from metrics_tpu.functional.image.fid_math import _compute_fid as jax_compute_fid
from metrics_tpu.models.inception import (
    _tf1_bilinear_resize as jax_resize,
    inception_features,
    random_inception_params,
)
import metrics_tpu_torch.image as ti
from metrics_tpu_torch.convert import inception_state_from_jax, load_jax_state
from metrics_tpu_torch.functional.image.fid_math import _compute_fid
from metrics_tpu_torch.models.inception import (
    FEATURE_DIMS,
    FeatureExtractorInceptionV3,
    _tf1_bilinear_resize,
    load_inception_feature_extractor,
    random_inception_state,
)

TAPS = (64, 192, 768, 2048, "logits_unbiased")
FEATURE_ATOL = 1e-3
REL = 1e-5
D = 16


@pytest.fixture(scope="module")
def weights():
    return random_inception_params(0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(7)
    return {
        "i299": rng.randint(0, 256, (2, 3, 299, 299)).astype(np.uint8),
        "iodd": rng.randint(0, 256, (2, 3, 67, 45)).astype(np.uint8),
    }


@pytest.fixture(scope="module")
def jax_features(weights, inputs):
    return {
        (tag, tap): np.asarray(inception_features(weights, jnp.asarray(img), tap))
        for tag, img in inputs.items()
        for tap in TAPS
    }


@pytest.fixture(scope="module")
def net(weights):
    return FeatureExtractorInceptionV3(state=inception_state_from_jax(weights), device="cpu")


# ------------------------------------------------------------------- network


def test_random_state_is_the_jax_draws(weights):
    ours = random_inception_state(0)
    carried = inception_state_from_jax(weights)
    assert set(ours) == set(carried) == set(FeatureExtractorInceptionV3(device="cpu").state_dict())
    for name, value in carried.items():
        np.testing.assert_array_equal(value.numpy(), ours[name], err_msg=name)


@pytest.mark.parametrize("tag", ["i299", "iodd"])
@pytest.mark.parametrize("tap", TAPS)
def test_forward_matches_jax_at_every_tap(net, inputs, jax_features, tag, tap):
    got = net(torch.from_numpy(inputs[tag]), tap).numpy()
    want = jax_features[(tag, tap)]
    assert got.shape == want.shape == (2, FEATURE_DIMS[tap])
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)


@pytest.mark.parametrize("tag", ["i299", "iodd"])
@pytest.mark.parametrize("tap", TAPS)
def test_forward_matches_the_frozen_golden(inputs, tag, tap):
    import os

    golden = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "inception_golden.npz"))
    net = FeatureExtractorInceptionV3(tap, state=random_inception_state(0), device="cpu")
    got = net(torch.from_numpy(inputs[tag])).numpy()[:, :16]
    np.testing.assert_allclose(got, golden[f"{tag}_{tap}"], rtol=0, atol=FEATURE_ATOL)


def test_bf16_path_stays_near_float32(net, inputs):
    """bf16 operands (float32 accumulation, batch norm and relu) against float32: within
    1% of the largest feature, where the JAX package's bf16 path moves its features by
    ~0.4% on these weights."""
    bf16 = FeatureExtractorInceptionV3(compute_dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(net.state_dict())
    img = torch.from_numpy(inputs["i299"])
    got, want = bf16(img).numpy(), net(img).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("size", [(7, 5, 11, 9), (32, 32, 299, 299), (300, 20, 299, 299), (5, 5, 5, 5)])
def test_tf1_resize_matches_jax(size):
    in_h, in_w, out_h, out_w = size
    x = np.random.RandomState(3).rand(2, 3, in_h, in_w).astype(np.float32) * 255
    want = np.asarray(jax_resize(jnp.asarray(x), out_h, out_w))
    got = _tf1_bilinear_resize(torch.from_numpy(x), out_h, out_w).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_invalid_tap_raises():
    with pytest.raises(ValueError, match="feature"):
        FeatureExtractorInceptionV3(1000, device="cpu")


def test_weights_file_path_and_its_absence(monkeypatch, tmp_path, inputs):
    import metrics_tpu.models.inception as jax_inception

    monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS", raising=False)
    for loader in (jax_inception.load_inception_feature_extractor, load_inception_feature_extractor):
        with pytest.raises(ModuleNotFoundError, match="METRICS_TPU_INCEPTION_WEIGHTS"):
            loader(2048)
    with pytest.raises(ModuleNotFoundError):
        ti.FrechetInceptionDistance(feature=2048, device="cpu")
    path = tmp_path / "inception.npz"
    np.savez(path, **random_inception_state(0))
    monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", str(path))
    extractor, dim = load_inception_feature_extractor(64, device="cpu")
    jax_extractor, jax_dim = jax_inception.load_inception_feature_extractor(64)
    img = inputs["iodd"]
    assert dim == jax_dim == 64
    np.testing.assert_allclose(extractor(torch.from_numpy(img)).numpy(), np.asarray(jax_extractor(jnp.asarray(img))),
                               rtol=0, atol=FEATURE_ATOL)
    fid = ti.FrechetInceptionDistance(feature=64, device="cpu")
    assert fid.real_mean.shape == (64,)
    with pytest.raises(ValueError, match="must be one of"):
        load_inception_feature_extractor(100, device="cpu")


# ------------------------------------------------------------------- metrics


def jax_extractor(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :D].astype(jnp.float32)


def torch_extractor(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :D].to(torch.float32)


def image_sets(seed, n=48, shift=0.1):
    rng = np.random.RandomState(seed)
    real = rng.rand(n, 3, 4, 4).astype(np.float32)
    fake = (rng.rand(n, 3, 4, 4) * 1.1 + shift).astype(np.float32)
    return real, fake


def assert_rel(got, want, rel=REL):
    got = [float(g) for g in (got if isinstance(got, tuple) else (got,))]
    want = [float(w) for w in (want if isinstance(want, tuple) else (want,))]
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.mark.parametrize("num_features", [None, D])
@pytest.mark.parametrize("batch", [48, 16, 7])
def test_fid_matches_jax(num_features, batch):
    real, fake = image_sets(0)
    jm = ji.FrechetInceptionDistance(feature=jax_extractor, num_features=num_features)
    tm = ti.FrechetInceptionDistance(feature=torch_extractor, num_features=num_features, device="cpu")
    for lo in range(0, len(real), batch):
        jm.update(jnp.asarray(real[lo : lo + batch]), real=True)
        jm.update(jnp.asarray(fake[lo : lo + batch]), real=False)
        tm.update(torch.from_numpy(real[lo : lo + batch]), real=True)
        tm.update(torch.from_numpy(fake[lo : lo + batch]), real=False)
    assert_rel(tm.compute(), jm.compute())


@pytest.mark.parametrize("reset_real_features", [True, False])
def test_fid_reset_real_features(reset_real_features):
    real, fake = image_sets(1)
    jm = ji.FrechetInceptionDistance(feature=jax_extractor, reset_real_features=reset_real_features)
    tm = ti.FrechetInceptionDistance(feature=torch_extractor, reset_real_features=reset_real_features, device="cpu")
    for m, arr in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        m.update(arr(real), real=True)
        m.update(arr(fake), real=False)
    assert_rel(tm.compute(), jm.compute())
    jm.reset()
    tm.reset()
    assert float(tm.real_features_num_samples) == float(jm.real_features_num_samples)
    for m, arr in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        m.update(arr(fake[:24] + 0.05), real=False)
        if reset_real_features:
            m.update(arr(real[:24]), real=True)
    assert_rel(tm.compute(), jm.compute())


def test_fid_normalize_casts_to_uint8_as_jax():
    """(imgs * 255).astype(uint8) truncates; values at k/255 land on k or k-1 alike."""
    levels = (np.arange(48 * 48) % 256).astype(np.float32).reshape(48, 3, 4, 4) / 255
    fake = (levels[::-1] * 0.8 + 0.1).astype(np.float32)
    jm = ji.FrechetInceptionDistance(feature=jax_extractor, normalize=True)
    tm = ti.FrechetInceptionDistance(feature=torch_extractor, normalize=True, device="cpu")
    cast = (torch.from_numpy(levels) * 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(cast, np.asarray((jnp.asarray(levels) * 255).astype(jnp.uint8)))
    for m, arr in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        m.update(arr(levels), real=True)
        m.update(arr(fake), real=False)
    np.testing.assert_array_equal(tm.real_mean.numpy(), np.asarray(jm.real_mean))
    assert_rel(tm.compute(), jm.compute())


def test_fid_needs_two_samples_per_set():
    real, fake = image_sets(2)
    for m, arr in (
        (ji.FrechetInceptionDistance(feature=jax_extractor), jnp.asarray),
        (ti.FrechetInceptionDistance(feature=torch_extractor, device="cpu"), torch.from_numpy),
    ):
        with pytest.raises(RuntimeError, match="More than one sample"):
            m.compute()
        m.update(arr(real[:1]), real=True)
        m.update(arr(fake), real=False)
        with pytest.raises(RuntimeError, match="More than one sample"):
            m.compute()


def test_fid_feature_argument_checks():
    for module in (ji, ti):
        kwargs = {} if module is ji else {"device": "cpu"}
        with pytest.raises(TypeError):
            module.FrechetInceptionDistance(feature=[1], **kwargs)
        with pytest.raises(ValueError, match="reset_real_features"):
            module.FrechetInceptionDistance(feature=jax_extractor, reset_real_features=1, **kwargs)
        with pytest.raises(ValueError, match="normalize"):
            module.FrechetInceptionDistance(feature=jax_extractor, normalize=1, **kwargs)


SHARES = (11, 20, 17)


def test_fid_stacked_sync_fold_matches_one_process_on_the_union():
    """Three ranks' triples gathered by the port's eager sync (stacked, reduction None)
    and folded at compute equal one JAX process on the union."""
    real, fake = image_sets(3)
    ranks = []

    def gather(tensor, group=None):
        name = next(n for n in ranks[0]._defaults if getattr(ranks[0], n) is tensor)
        return [getattr(rank, name) for rank in ranks]

    bounds = np.cumsum((0,) + SHARES)
    for k in range(len(SHARES)):
        kwargs = {"dist_sync_fn": gather, "distributed_available_fn": lambda: True} if k == 0 else {}
        m = ti.FrechetInceptionDistance(feature=torch_extractor, device="cpu", **kwargs)
        m.update(torch.from_numpy(real[bounds[k] : bounds[k + 1]]), real=True)
        m.update(torch.from_numpy(fake[bounds[k] : bounds[k + 1]]), real=False)
        ranks.append(m)
    union = ji.FrechetInceptionDistance(feature=jax_extractor)
    union.update(jnp.asarray(real[: bounds[-1]]), real=True)
    union.update(jnp.asarray(fake[: bounds[-1]]), real=False)
    assert_rel(ranks[0].compute(), union.compute())
    assert ranks[0].real_mean.shape == (D,)  # unsynced again


def test_fid_load_jax_state_plain_and_stacked():
    real, fake = image_sets(4)
    bounds = np.cumsum((0,) + SHARES)
    shards = []
    for k in range(len(SHARES)):
        m = ji.FrechetInceptionDistance(feature=jax_extractor)
        m.update(jnp.asarray(real[bounds[k] : bounds[k + 1]]), real=True)
        m.update(jnp.asarray(fake[bounds[k] : bounds[k + 1]]), real=False)
        m.persistent(True)
        shards.append(m)
    union = ji.FrechetInceptionDistance(feature=jax_extractor)
    union.update(jnp.asarray(real[: bounds[-1]]), real=True)
    union.update(jnp.asarray(fake[: bounds[-1]]), real=False)
    union.persistent(True)
    plain = load_jax_state(ti.FrechetInceptionDistance(feature=torch_extractor, device="cpu"), union.state_dict())
    assert_rel(plain.compute(), union.compute())
    states = [s.state_dict() for s in shards]
    stacked = {name: np.stack([np.asarray(s[name]) for s in states]) for name in states[0]}
    folded = load_jax_state(ti.FrechetInceptionDistance(feature=torch_extractor, device="cpu"), stacked)
    assert folded.real_mean.shape == (len(SHARES), D)
    assert_rel(folded.compute(), union.compute())


@pytest.mark.parametrize("kwargs", [{}, {"degree": 2, "gamma": 0.5, "coef": 2.0}, {"subsets": 1}], ids=str)
def test_kid_matches_jax(kwargs):
    real, fake = image_sets(5)
    kwargs = {"subsets": 6, "subset_size": 20, **kwargs}
    jm = ji.KernelInceptionDistance(feature=jax_extractor, **kwargs)
    tm = ti.KernelInceptionDistance(feature=torch_extractor, **kwargs, device="cpu")
    for lo in range(0, len(real), 16):
        for m, arr in ((jm, jnp.asarray), (tm, torch.from_numpy)):
            m.update(arr(real[lo : lo + 16]), real=True)
            m.update(arr(fake[lo : lo + 16]), real=False)
    np.random.seed(11)
    want = jm.compute()
    np.random.seed(11)
    got = tm.compute()
    if kwargs["subsets"] == 1:  # no spread over one subset: NaN in both
        assert_rel(got[0], want[0])
        assert np.isnan(float(got[1])) and np.isnan(float(want[1]))
    else:
        assert_rel(got, want)


def test_kid_chunked_subsets_equal_one_chunk(monkeypatch):
    import metrics_tpu_torch.image.kid as kid

    real, fake = image_sets(6)
    tm = ti.KernelInceptionDistance(feature=torch_extractor, subsets=7, subset_size=30, device="cpu")
    tm.update(torch.from_numpy(real), real=True)
    tm.update(torch.from_numpy(fake), real=False)
    np.random.seed(3)
    whole = tm.compute()
    monkeypatch.setattr(kid, "_KID_CHUNK_BYTES", 1)  # one subset per chunk
    tm._computed = None
    np.random.seed(3)
    chunked = tm.compute()
    assert_rel(chunked, whole, rel=1e-6)


def test_kid_subset_size_and_reset_real_features():
    real, fake = image_sets(7)
    for module, arr in ((ji, jnp.asarray), (ti, torch.from_numpy)):
        kwargs = {} if module is ji else {"device": "cpu"}
        m = module.KernelInceptionDistance(
            feature=jax_extractor if module is ji else torch_extractor, subset_size=30, reset_real_features=False,
            **kwargs,
        )
        m.update(arr(real[:20]), real=True)
        m.update(arr(fake), real=False)
        with pytest.raises(ValueError, match="subset_size"):
            m.compute()
        m.reset()
        assert len(m.real_features) == 1 and len(m.fake_features) == 0
        m.update(arr(fake[:20]), real=False)
        with pytest.raises(ValueError, match="subset_size"):
            m.compute()
    for bad in ({"subsets": 0}, {"subset_size": -1}, {"degree": 0}, {"gamma": 1}, {"coef": 0.0}):
        for module in (ji, ti):
            kwargs = {} if module is ji else {"device": "cpu"}
            with pytest.raises(ValueError):
                module.KernelInceptionDistance(feature=jax_extractor, **bad, **kwargs)


@pytest.mark.parametrize("splits", [1, 3, 10])
def test_inception_score_matches_jax(splits):
    rng = np.random.RandomState(8)
    logits = [(rng.randn(13, 10) * 2).astype(np.float32) for _ in range(3)]
    identity_j = lambda x: x  # noqa: E731
    jm = ji.InceptionScore(feature=identity_j, splits=splits)
    tm = ti.InceptionScore(feature=lambda x: x, splits=splits, device="cpu")
    for batch in logits:
        jm.update(jnp.asarray(batch))
        tm.update(torch.from_numpy(batch))
    np.random.seed(5)
    want = jm.compute()
    np.random.seed(5)
    got = tm.compute()
    if splits == 1:
        assert_rel(got[0], want[0])
        assert np.isnan(float(got[1])) and np.isnan(float(want[1]))
    else:
        assert_rel(got, want)


def test_kid_and_is_load_jax_state():
    real, fake = image_sets(9)
    jk = ji.KernelInceptionDistance(feature=jax_extractor, subsets=4, subset_size=16)
    jk.update(jnp.asarray(real), real=True)
    jk.update(jnp.asarray(fake), real=False)
    jk.persistent(True)
    tk = load_jax_state(ti.KernelInceptionDistance(feature=torch_extractor, subsets=4, subset_size=16, device="cpu"),
                        jk.state_dict())
    np.random.seed(2)
    want = jk.compute()
    np.random.seed(2)
    assert_rel(tk.compute(), want)
    logits = np.random.RandomState(10).randn(40, 7).astype(np.float32)
    ji_is = ji.InceptionScore(feature=lambda x: x, splits=4)
    ji_is.update(jnp.asarray(logits))
    ji_is.persistent(True)
    ti_is = load_jax_state(ti.InceptionScore(feature=lambda x: x, splits=4, device="cpu"), ji_is.state_dict())
    np.random.seed(4)
    want = ji_is.compute()
    np.random.seed(4)
    assert_rel(ti_is.compute(), want)


# ----------------------------------------------------------------- fid math


def spd(rng, n, rank=None):
    a = rng.randn(n, rank or n)
    return a @ a.T / (rank or n) + 1e-3 * np.eye(n)


@pytest.mark.parametrize("method", ["auto", "eigh", "newton_schulz"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compute_fid_methods_match_jax(method, dtype):
    rng = np.random.RandomState(12)
    mu1, mu2 = rng.randn(24), rng.randn(24)
    s1, s2 = spd(rng, 24), spd(rng, 24, rank=30)
    args = [a.astype(dtype) for a in (mu1, s1, mu2, s2)]
    want = float(jax_compute_fid(*(jnp.asarray(a) for a in args), method="eigh" if method == "auto" else method))
    got = float(_compute_fid(*(torch.from_numpy(a) for a in args), method=method))
    exact = float(_compute_fid(*(torch.from_numpy(a.astype(np.float64)) for a in (mu1, s1, mu2, s2)), method="eigh"))
    # float32: each package within 1e-4 of float64 (Newton-Schulz's floor); float64: within 1e-9
    tol = 1e-9 if dtype == np.float64 and method != "newton_schulz" else 1e-4
    assert abs(got - exact) <= tol * abs(exact)
    if dtype == np.float32 or method != "newton_schulz":
        assert abs(got - want) <= 2 * max(tol, REL) * abs(exact)


def test_compute_fid_unknown_method():
    x = torch.eye(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="Unknown FID sqrtm method"):
        _compute_fid(x[0], x, x[1], x, method="svd")


# ------------------------------------------- deviations: KID and IS in float64


def test_kid_is_float64_on_large_features():
    """Features of mean ~24, as the seeded random InceptionV3 gives: the cubic kernel is
    ~1e8 times the MMD's size. The port (float64) stays within 1e-6 of float64 numpy."""
    rng = np.random.RandomState(14)
    real = (rng.randn(60, 64) * 8 + 24).astype(np.float32)
    fake = (rng.randn(60, 64) * 8 + 25).astype(np.float32)
    tm = ti.KernelInceptionDistance(feature=lambda x: x, subsets=4, subset_size=30, device="cpu")
    tm.update(torch.from_numpy(real), real=True)
    tm.update(torch.from_numpy(fake), real=False)
    np.random.seed(1)
    got = tm.compute()
    np.random.seed(1)
    rng = np.random.default_rng(np.random.randint(0, 2**31))
    idx_real = [rng.permutation(60)[:30] for _ in range(4)]
    idx_fake = [rng.permutation(60)[:30] for _ in range(4)]
    scores = []
    for ir, if_ in zip(idx_real, idx_fake):
        x, y = real[ir].astype(np.float64), fake[if_].astype(np.float64)
        kxx, kyy, kxy = ((a @ b.T / 64 + 1.0) ** 3 for a, b in ((x, x), (y, y), (x, y)))
        scores.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (30 * 29) - 2 * kxy.mean())
    assert_rel(got, (np.mean(scores), np.std(scores, ddof=1)), rel=1e-6)


def test_is_float64_where_float32_softmax_underflows():
    """A class 150 below the top logit of every image: in float32 its probability
    underflows to 0 throughout and the JAX package's score is NaN (0 * log 0); the
    port's float64 score is finite and equals float64 numpy."""
    logits = np.random.RandomState(15).randn(40, 8).astype(np.float32) * 4
    logits[:, 0] = logits.max(1) - 150
    jm = ji.InceptionScore(feature=lambda x: x, splits=4)
    tm = ti.InceptionScore(feature=lambda x: x, splits=4, device="cpu")
    jm.update(jnp.asarray(logits))
    tm.update(torch.from_numpy(logits))
    np.random.seed(6)
    assert np.isnan(float(jm.compute()[0]))
    np.random.seed(6)
    got = tm.compute()
    np.random.seed(6)
    perm = np.random.permutation(40)
    x = logits[perm].astype(np.float64)
    log_p = x - x.max(1, keepdims=True)
    log_p -= np.log(np.exp(log_p).sum(1, keepdims=True))
    kls = [(np.exp(lp) * (lp - np.log(np.exp(lp).mean(0, keepdims=True)))).sum(1).mean()
           for lp in np.array_split(log_p, 4)]
    assert_rel(got, (np.mean(kls), np.std(kls, ddof=1)), rel=1e-6)
