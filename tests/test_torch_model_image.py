"""CLIP, CLIPScore and LPIPS of metrics_tpu_torch against metrics_tpu, on the CPU.

Seeded numpy weights, written to temporary ``.npz`` files where a package loads by
path, go through both packages (``device="cpu"``):

- both CLIP towers of a tiny HF-layout CLIP (width 64, 64-wide heads, 2 layers, 32 px,
  patch 8) within 2e-4, the frozen ``clip_golden.npz`` (features within 2e-4,
  ``pixel_values`` within 1e-5), ``preprocess`` at up- and down-sampling on uint8 and
  float inputs of both ranges within 1e-5, the checkpoint encoders, CLIPScore's
  functional and class over three updates, its errors, and the default
  ``transformers`` path with fakes patched over ``from_pretrained``;
- LPIPS at full width: AlexNet and VGG16 at 64x64, SqueezeNet-1.1 at 67x61 (its
  ceil-mode pools at odd sizes), both ``normalize``, functional and class, within
  1e-4 relative; the missing-weights errors by type and message, the other argument
  errors, the environment variables and the root names;
- ``clip_state_from_jax``, ``lpips_state_from_jax`` and ``load_jax_state`` of CLIPScore
  and LPIPS (int64 counts).
"""
import sys
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jfr
import metrics_tpu.functional.image.lpips as j_lpips_fn
import metrics_tpu.functional.multimodal.clip_score  # noqa: F401  (the package exports a function of that name)
import metrics_tpu.image as ji
import metrics_tpu.models.clip as j_clip
import metrics_tpu.models.lpips as j_lpips
import metrics_tpu.multimodal as jm
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.image.lpips as t_lpips_fn
import metrics_tpu_torch.functional.multimodal.clip_score  # noqa: F401
import metrics_tpu_torch.image as ti
import metrics_tpu_torch.models.clip as t_clip
import metrics_tpu_torch.models.lpips as t_lpips
import metrics_tpu_torch.multimodal as tm
from metrics_tpu_torch.convert import clip_state_from_jax, load_jax_state, lpips_state_from_jax
from tests.torch_deadline import deadline  # noqa: F401

j_clip_fn = sys.modules["metrics_tpu.functional.multimodal.clip_score"]
t_clip_fn = sys.modules["metrics_tpu_torch.functional.multimodal.clip_score"]

CPU = {"device": "cpu"}
WIDTH, LAYERS, VOCAB, IMG, PATCH, PROJ = 64, 2, 64, 32, 8, 16
EOS = VOCAB - 1
FIXTURES = __file__.rsplit("/", 1)[0] + "/fixtures"
WORDS = "a photo of the cat dog on red blue mat sitting near big small tree house car".split()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small forwards run op by op; more threads than one only contend (and the
    JAX side has its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ------------------------------------------------------------------------ CLIP


def hf_clip_state(seed: int) -> dict:
    """A HF ``CLIPModel`` state dict of seeded weights (tiny config)."""
    rng = np.random.RandomState(seed)
    state = {}

    def w(*shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln(key):
        state[f"{key}.weight"], state[f"{key}.bias"] = (1 + w(WIDTH, scale=0.1)).astype(np.float32), w(WIDTH)

    def lin(key, i, o):
        state[f"{key}.weight"], state[f"{key}.bias"] = w(o, i), w(o, scale=0.02)

    for tower in ("text_model", "vision_model"):
        for i in range(LAYERS):
            base = f"{tower}.encoder.layers.{i}."
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(base + "self_attn." + name, WIDTH, WIDTH)
            ln(base + "layer_norm1")
            ln(base + "layer_norm2")
            lin(base + "mlp.fc1", WIDTH, 4 * WIDTH)
            lin(base + "mlp.fc2", 4 * WIDTH, WIDTH)
    state["text_model.embeddings.token_embedding.weight"] = w(VOCAB, WIDTH, scale=0.5)
    state["text_model.embeddings.position_embedding.weight"] = w(16, WIDTH, scale=0.5)
    ln("text_model.final_layer_norm")
    state["text_projection.weight"] = w(PROJ, WIDTH, scale=0.2)
    state["vision_model.embeddings.class_embedding"] = w(WIDTH, scale=0.5)
    state["vision_model.embeddings.patch_embedding.weight"] = w(WIDTH, 3, PATCH, PATCH, scale=0.1)
    state["vision_model.embeddings.position_embedding.weight"] = w((IMG // PATCH) ** 2 + 1, WIDTH, scale=0.5)
    ln("vision_model.pre_layrnorm")
    ln("vision_model.post_layernorm")
    state["visual_projection.weight"] = w(PROJ, WIDTH, scale=0.2)
    return state


class ClipTokenizer:
    """A HF-style word tokenizer for the tiny CLIP: ``BOS words EOS``, ids from a seeded
    CRC of each word, padded with 0 to the longest row."""

    pad_token_id = 0

    def __call__(self, captions, padding=True, truncation=True, max_length=77, return_tensors="np"):
        rows = [[EOS - 1] + [1 + zlib.crc32(w.encode(), 3) % (EOS - 2) for w in c.split()][: max_length - 2] + [EOS]
                for c in captions]
        ids = np.zeros((len(rows), max(len(r) for r in rows)), np.int64)
        mask = np.zeros_like(ids)
        for r, row in enumerate(rows):
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        return {"input_ids": ids, "attention_mask": mask}


def captions(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [" ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(3, 11))) for _ in range(n)]


def uint8_images(seed: int, n: int, h: int = 40, w: int = 48) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, 3, h, w)).astype(np.uint8)


@pytest.fixture(scope="module")
def clip_models():
    state = hf_clip_state(0)
    return j_clip.params_from_state_dict(state), t_clip.CLIPModel.from_state(t_clip.params_from_state_dict(state),
                                                                            1, 1, **CPU)


@pytest.fixture(scope="module")
def clip_encoders(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.npz")
    np.savez(path, **hf_clip_state(1))
    tok = ClipTokenizer()
    kwargs = {"image_size": IMG, "eos_token_id": EOS, "max_length": 16}
    return (j_clip.jax_clip_encoders(path, tok, **kwargs),
            t_clip.torch_clip_encoders(path, tok, **kwargs, **CPU))


def test_text_tower_matches_jax(clip_models):
    params, model = clip_models
    rng = np.random.RandomState(0)
    ids = rng.randint(1, EOS - 1, (3, 10)).astype(np.int64)
    ids[:, -1] = EOS
    ids[1, 6:] = 0
    ids[1, 5] = EOS
    mask = (ids != 0).astype(np.int64)
    want = j_clip.clip_text_features(params, jnp.asarray(ids), jnp.asarray(mask), 1, EOS)
    got = model.text_features(torch.from_numpy(ids), torch.from_numpy(mask), EOS)
    close(got, want, 2e-4)


def test_vision_tower_matches_jax(clip_models):
    params, model = clip_models
    pixels = np.random.RandomState(1).randn(2, 3, IMG, IMG).astype(np.float32)
    close(model.image_features(torch.from_numpy(pixels)), j_clip.clip_image_features(params, jnp.asarray(pixels), 1),
          2e-4)


def test_clip_frozen_golden():
    data = np.load(f"{FIXTURES}/clip_golden.npz")
    state = {k.split("::", 1)[1]: data[k] for k in data.files if k.startswith("state::")}
    model = t_clip.CLIPModel.from_state(t_clip.params_from_state_dict(state), 4, 4, **CPU)
    pixel = t_clip.preprocess(torch.from_numpy(data["imgs"]), size=32)
    close(pixel, data["pixel_values"], 1e-5)
    ids, mask = (torch.as_tensor(data[k], dtype=torch.int64) for k in ("ids", "mask"))
    close(model.text_features(ids, mask, 98), data["text_features"], 2e-4)
    close(model.image_features(pixel), data["image_features"], 2e-4)


def test_clip_state_from_jax_gives_equal_outputs(clip_models):
    params, model = clip_models
    carried = t_clip.CLIPModel.from_state(clip_state_from_jax(params), 1, 1, **CPU)
    pixels = torch.from_numpy(np.random.RandomState(2).randn(2, 3, IMG, IMG).astype(np.float32))
    ids = torch.tensor([[EOS - 1, 5, 9, EOS, 0]])
    assert torch.equal(carried.image_features(pixels), model.image_features(pixels))
    assert torch.equal(carried.text_features(ids, ids != 0, EOS), model.text_features(ids, ids != 0, EOS))


PREPROCESS_CASES = [  # (shape, size, dtype, scale, unit_range)
    ((2, 3, 48, 64), 24, "uint8", 255, None),
    ((2, 3, 20, 30), 224, "uint8", 255, None),
    ((1, 3, 48, 64), 24, "float32", 1, None),
    ((1, 3, 20, 30), 224, "float32", 1, True),
    ((2, 3, 48, 64), 24, "float32", 255, None),
    ((1, 3, 20, 30), 224, "float32", 255, False),
    ((3, 5, 2), 5, "uint8", 255, None),  # 12.5 -> 12: Python's round to even
    ((2, 3, 37, 29), 16, "float32", 1, None),
]


@pytest.mark.parametrize("shape,size,dtype,scale,unit_range", PREPROCESS_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in PREPROCESS_CASES])
def test_preprocess_matches_jax(shape, size, dtype, scale, unit_range):
    rng = np.random.RandomState(sum(shape) + size)
    images = (rng.randint(0, 256, shape) if dtype == "uint8" else rng.uniform(0, scale, shape)).astype(dtype)
    want = np.asarray(j_clip.preprocess(jnp.asarray(images), size, unit_range))
    got = t_clip.preprocess(torch.from_numpy(images), size, unit_range)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    close(got, want, 1e-5)


def test_checkpoint_encoders_match_jax(clip_encoders):
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    images = uint8_images(3, 3)
    close(t_img(torch.from_numpy(images)), j_img(jnp.asarray(images)), 2e-4)
    close(t_img([torch.from_numpy(i) for i in images]), j_img([jnp.asarray(i) for i in images]), 2e-4)
    text = captions(3, 3)
    close(t_txt(text), j_txt(text), 2e-4)


def test_clip_score_matches_jax(clip_encoders):
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    images, text = uint8_images(4, 4), captions(4, 4)
    want = j_clip_fn.clip_score(jnp.asarray(images), text, image_encoder=j_img, text_encoder=j_txt)
    got = t_clip_fn.clip_score(torch.from_numpy(images), text, image_encoder=t_img, text_encoder=t_txt)
    close(got, want, 1e-3)
    got = t_clip_fn.clip_score(images, text, image_encoder=t_img, text_encoder=t_txt, **CPU)  # numpy in
    close(got, want, 1e-3)
    single = t_clip_fn.clip_score(torch.from_numpy(images[0]), text[0], image_encoder=t_img, text_encoder=t_txt)
    close(single, j_clip_fn.clip_score(jnp.asarray(images[0]), text[0], image_encoder=j_img, text_encoder=j_txt),
          1e-3)


def _error(fn, *args, **kwargs):
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


def test_clip_score_errors_match_jax(clip_encoders):
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    images = uint8_images(5, 2)
    j, t = {"image_encoder": j_img, "text_encoder": j_txt}, {"image_encoder": t_img, "text_encoder": t_txt}
    assert _error(t_clip_fn.clip_score, torch.from_numpy(images), ["a"], **t) == \
        _error(j_clip_fn.clip_score, jnp.asarray(images), ["a"], **j)
    assert _error(t_clip_fn.clip_score, [torch.from_numpy(images)], ["a"], **t) == \
        _error(j_clip_fn.clip_score, [jnp.asarray(images)], ["a"], **j)
    assert _error(t_clip_fn.clip_score, images, ["a", "b"], image_encoder=t_img, **CPU) == \
        _error(j_clip_fn.clip_score, images, ["a", "b"], image_encoder=j_img)
    assert _error(tm.CLIPScore, text_encoder=t_txt, **CPU) == _error(jm.CLIPScore, text_encoder=j_txt)


def test_clip_score_class_matches_jax(clip_encoders):
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    jmetric = jm.CLIPScore(image_encoder=j_img, text_encoder=j_txt)
    tmetric = tm.CLIPScore(image_encoder=t_img, text_encoder=t_txt, **CPU)
    for i in range(3):
        images, text = uint8_images(10 + i, 2 + i), captions(10 + i, 2 + i)
        close(tmetric(torch.from_numpy(images), text), jmetric(jnp.asarray(images), text), 1e-3)
    close(tmetric.compute(), jmetric.compute(), 1e-3)
    assert tmetric.n_samples.dtype == torch.int64 and int(tmetric.n_samples) == int(jmetric.n_samples) == 9
    close(tmetric.score, jmetric.score, 1e-3 * 9)
    tmetric.reset()
    tmetric.update([torch.from_numpy(i) for i in uint8_images(20, 2)], captions(20, 2))
    assert int(tmetric.n_samples) == 2


def test_clip_score_load_jax_state(clip_encoders):
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    jmetric = jm.CLIPScore(image_encoder=j_img, text_encoder=j_txt)
    jmetric.update(jnp.asarray(uint8_images(30, 3)), captions(30, 3))
    jmetric.persistent(True)
    tmetric = load_jax_state(tm.CLIPScore(image_encoder=t_img, text_encoder=t_txt, **CPU), jmetric.state_dict())
    assert tmetric.n_samples.dtype == torch.int64 and int(tmetric.n_samples) == 3
    close(tmetric.compute(), jmetric.compute(), 1e-5)


class _FakeCLIPModel:
    """``CLIPModel.from_pretrained``'s stand-in: pixel means and a seeded embedding sum."""

    def eval(self):
        return self

    def to(self, device):
        return self

    def get_image_features(self, pixel_values):
        return pixel_values.flatten(2).mean(-1).repeat(1, 4).float()

    def get_text_features(self, input_ids, attention_mask):
        table = torch.randn(VOCAB, 12, generator=torch.Generator().manual_seed(1))
        return (table[input_ids] * attention_mask[..., None]).sum(1)


class _FakeCLIPProcessor:
    def __call__(self, images=None, text=None, return_tensors="pt", padding=True):
        if images is not None:
            return {"pixel_values": torch.from_numpy(np.stack([np.asarray(i, np.float32) for i in images]))}
        return ClipTokenizer()(text, return_tensors="pt")


def test_default_transformers_path_matches_jax(monkeypatch):
    transformers = pytest.importorskip("transformers")
    monkeypatch.setattr(transformers.CLIPModel, "from_pretrained", classmethod(lambda cls, n: _FakeCLIPModel()))
    monkeypatch.setattr(transformers.CLIPProcessor, "from_pretrained",
                        classmethod(lambda cls, n: _FakeCLIPProcessor()))
    images, text = uint8_images(6, 3, 8, 8), captions(6, 3)
    want = j_clip_fn.clip_score(jnp.asarray(images), text)
    close(t_clip_fn.clip_score(torch.from_numpy(images), text, **CPU), want, 1e-4)
    jmetric, tmetric = jm.CLIPScore(), tm.CLIPScore(**CPU)
    jmetric.update(jnp.asarray(images), text)
    tmetric.update(torch.from_numpy(images), text)
    close(tmetric.compute(), jmetric.compute(), 1e-4)


# ----------------------------------------------------------------------- LPIPS


def backbone_state(net_type: str, seed: int) -> dict:
    """Seeded torchvision-layout weights: He-scaled convs, small biases."""
    rng = np.random.RandomState(seed)
    state = {}
    for key, shape in t_lpips.backbone_shapes(net_type).items():
        if key.endswith("weight"):
            state[key] = (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))).astype(np.float32)
        else:
            state[key] = (rng.randn(*shape) * 0.01).astype(np.float32)
    return state


def lin_state(net_type: str, seed: int, layout: str = "lin{}") -> dict:
    rng = np.random.RandomState(seed)
    return {f"{layout.format(i)}.model.1.weight": (np.abs(rng.randn(1, c, 1, 1)) / c).astype(np.float32)
            for i, c in enumerate(t_lpips.LPIPS_CHANNELS[net_type])}


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    files = {}
    for n, net_type in enumerate(("alex", "vgg", "squeeze")):
        backbone, lins = root / f"{net_type}.npz", root / f"{net_type}_lin.npz"
        np.savez(backbone, **backbone_state(net_type, n))
        np.savez(lins, **lin_state(net_type, 10 + n, "lins.{}" if net_type == "vgg" else "lin{}"))
        files[net_type] = {"backbone_weights": str(backbone), "linear_weights": str(lins)}
    return files


def image_pair(seed: int, n: int, h: int, w: int, normalize: bool):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, 3, h, w)).astype(np.float32)
    b = np.clip(a + 0.4 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    return ((a + 1) / 2, (b + 1) / 2) if normalize else (a, b)


LPIPS_CASES = [("alex", 64, 64), ("vgg", 64, 64), ("squeeze", 67, 61)]


@pytest.mark.parametrize("normalize", [False, True], ids=["pm1", "unit"])
@pytest.mark.parametrize("net_type,h,w", LPIPS_CASES, ids=[c[0] for c in LPIPS_CASES])
def test_lpips_functional_matches_jax(lpips_files, net_type, h, w, normalize):
    img1, img2 = image_pair(h + w, 2, h, w, normalize)
    for reduction in ("mean", "sum"):
        kwargs = {"net_type": net_type, "reduction": reduction, "normalize": normalize, **lpips_files[net_type]}
        want = float(j_lpips_fn.learned_perceptual_image_patch_similarity(jnp.asarray(img1), jnp.asarray(img2),
                                                                          **kwargs))
        got = t_lpips_fn.learned_perceptual_image_patch_similarity(torch.from_numpy(img1), torch.from_numpy(img2),
                                                                   **kwargs)
        assert got.dtype == torch.float32 and want > 0
        close(got, want, 0, rtol=1e-4)


def test_lpips_network_matches_jax_per_sample(lpips_files):
    net = t_lpips.load_lpips("squeeze", **lpips_files["squeeze"], **CPU)
    backbone, lins = j_lpips.load_lpips("squeeze", **lpips_files["squeeze"])
    img1, img2 = image_pair(5, 2, 67, 61, False)
    want = np.asarray(j_lpips.lpips_forward(backbone, lins, jnp.asarray(img1), jnp.asarray(img2), "squeeze"))
    close(net(torch.from_numpy(img1), torch.from_numpy(img2)), want, 0, rtol=1e-4)
    assert float(net(torch.from_numpy(img1), torch.from_numpy(img1)).abs().max()) < 1e-6
    assert t_lpips.load_lpips("squeeze", **lpips_files["squeeze"], **CPU) is net  # cached


@pytest.mark.parametrize("net_type,normalize", [("alex", False), ("squeeze", True)])
def test_lpips_class_matches_jax(lpips_files, net_type, normalize):
    kwargs = {"net_type": net_type, "normalize": normalize, **lpips_files[net_type]}
    jmetric = ji.LearnedPerceptualImagePatchSimilarity(**kwargs)
    tmetric = ti.LearnedPerceptualImagePatchSimilarity(**kwargs, **CPU)
    for i in range(3):
        img1, img2 = image_pair(40 + i, 2, 65, 63, normalize)
        want = float(jmetric(jnp.asarray(img1), jnp.asarray(img2)))
        close(tmetric(torch.from_numpy(img1), torch.from_numpy(img2)), want, 0, rtol=1e-4)
    close(tmetric.compute(), float(jmetric.compute()), 0, rtol=1e-4)
    assert tmetric.total.dtype == torch.int64 and int(tmetric.total) == int(jmetric.total) == 6
    jmetric.persistent(True)
    loaded = load_jax_state(ti.LearnedPerceptualImagePatchSimilarity(**kwargs, **CPU), jmetric.state_dict())
    assert loaded.total.dtype == torch.int64 and int(loaded.total) == 6
    close(loaded.compute(), float(jmetric.compute()), 0, rtol=1e-6)
    state = dict(jmetric.state_dict(), total=np.asarray(6.5, np.float32))
    with pytest.raises(ValueError, match="non-integral"):
        load_jax_state(ti.LearnedPerceptualImagePatchSimilarity(**kwargs, **CPU), state)


def test_lpips_sum_reduction_and_identical_pair(lpips_files):
    metric = ti.LearnedPerceptualImagePatchSimilarity(reduction="sum", **lpips_files["alex"], **CPU)
    img1, img2 = image_pair(50, 3, 64, 64, False)
    metric.update(torch.from_numpy(img1), torch.from_numpy(img1))
    assert float(metric.compute()) < 1e-6
    metric.update(torch.from_numpy(img1), torch.from_numpy(img2))
    per_sample = t_lpips.load_lpips("alex", **lpips_files["alex"], **CPU)(torch.from_numpy(img1),
                                                                          torch.from_numpy(img2))
    close(metric.compute(), float(per_sample.sum()), 1e-6)


def _raised(fn, *args, **kwargs):
    with pytest.raises((ValueError, ModuleNotFoundError, KeyError)) as err:
        fn(*args, **kwargs)
    return type(err.value), str(err.value)


def test_lpips_errors_match_jax(lpips_files, monkeypatch, tmp_path):
    for name in ("ALEX", "VGG", "SQUEEZE"):
        monkeypatch.delenv(f"METRICS_TPU_LPIPS_{name}_WEIGHTS", raising=False)
    monkeypatch.delenv("METRICS_TPU_LPIPS_LINEAR_WEIGHTS", raising=False)
    cls_j, cls_t = ji.LearnedPerceptualImagePatchSimilarity, ti.LearnedPerceptualImagePatchSimilarity
    files = lpips_files["alex"]
    for kwargs in ({}, {"net_type": "vgg"}, {"backbone_weights": files["backbone_weights"]},
                   {"linear_weights": files["linear_weights"]}, {"net_type": "nope"},
                   {"reduction": "max", **files}, {"normalize": 1, **files}):
        assert _raised(cls_t, **kwargs, **CPU) == _raised(cls_j, **kwargs)
    assert _raised(t_lpips.load_lpips, "squeeze", **CPU) == _raised(j_lpips.load_lpips, "squeeze")
    for wrong in (np.zeros((2, 1, 8, 8), np.float32), np.full((2, 3, 8, 8), 2.0, np.float32)):
        j_type, j_msg = _raised(j_lpips_fn.learned_perceptual_image_patch_similarity, jnp.asarray(wrong),
                                jnp.asarray(wrong), normalize=True, **files)
        t_type, t_msg = _raised(t_lpips_fn.learned_perceptual_image_patch_similarity, torch.from_numpy(wrong),
                                torch.from_numpy(wrong), normalize=True, **files)
        # the value reprs differ (jax Array / torch tensor); the text around them is the same
        assert t_type is j_type is ValueError and t_msg.split(" and values")[0] == j_msg.split(" and values")[0]
    bad = tmp_path / "lin.npz"
    np.savez(bad, **{k: v for k, v in lin_state("alex", 0).items() if not k.startswith("lin4")})
    assert _raised(t_lpips.load_lpips, "alex", files["backbone_weights"], str(bad), **CPU) == \
        _raised(j_lpips.load_lpips, "alex", files["backbone_weights"], str(bad))


def test_lpips_weights_from_the_environment(lpips_files, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_LPIPS_VGG_WEIGHTS", lpips_files["vgg"]["backbone_weights"])
    monkeypatch.setenv("METRICS_TPU_LPIPS_LINEAR_WEIGHTS", lpips_files["vgg"]["linear_weights"])
    img1, img2 = image_pair(60, 2, 64, 64, False)
    want = float(j_lpips_fn.learned_perceptual_image_patch_similarity(jnp.asarray(img1), jnp.asarray(img2),
                                                                      net_type="vgg"))
    got = t_lpips_fn.learned_perceptual_image_patch_similarity(torch.from_numpy(img1), torch.from_numpy(img2),
                                                               net_type="vgg")
    close(got, want, 0, rtol=1e-4)


@pytest.mark.parametrize("net_type", ["alex", "vgg", "squeeze"])
def test_lpips_state_from_jax_gives_equal_outputs(lpips_files, net_type):
    backbone, lins = j_lpips.load_lpips(net_type, **lpips_files[net_type])
    carried = t_lpips.LPIPS.from_state(net_type, lpips_state_from_jax(backbone, lins, net_type), **CPU)
    direct = t_lpips.load_lpips(net_type, **lpips_files[net_type], **CPU)
    img1, img2 = image_pair(70, 2, 64, 64, False)
    assert torch.equal(carried(torch.from_numpy(img1), torch.from_numpy(img2)),
                       direct(torch.from_numpy(img1), torch.from_numpy(img2)))


def test_linear_weights_layouts_match_jax():
    for layout in ("lin{}", "lins.{}"):
        state = lin_state("squeeze", 1, layout)
        for got, want in zip(t_lpips.linear_weights_from_state_dict(state, "squeeze"),
                             j_lpips.linear_weights_from_state_dict(state, "squeeze")):
            np.testing.assert_array_equal(got, np.asarray(want))
    state = lin_state("alex", 1)
    del state["lin2.model.1.weight"]
    assert _raised(t_lpips.linear_weights_from_state_dict, state, "alex") == \
        _raised(j_lpips.linear_weights_from_state_dict, state, "alex")


def _warns(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return any(issubclass(w.category, FutureWarning) for w in caught)


def test_root_names_of_the_model_metrics_warn_as_in_jax(lpips_files, clip_encoders):
    """LPIPS and CLIPScore are root names of both packages; neither root warns for them."""
    (j_img, j_txt), (t_img, t_txt) = clip_encoders
    files = lpips_files["alex"]
    img = np.zeros((2, 3, 64, 64), np.float32)
    cases = [
        (lambda: metrics_tpu.LearnedPerceptualImagePatchSimilarity(**files),
         lambda: metrics_tpu_torch.LearnedPerceptualImagePatchSimilarity(**files, **CPU)),
        (lambda: jfr.learned_perceptual_image_patch_similarity(jnp.asarray(img), jnp.asarray(img), **files),
         lambda: tfr.learned_perceptual_image_patch_similarity(torch.from_numpy(img), torch.from_numpy(img), **files)),
        (lambda: metrics_tpu.CLIPScore(image_encoder=j_img, text_encoder=j_txt),
         lambda: metrics_tpu_torch.CLIPScore(image_encoder=t_img, text_encoder=t_txt, **CPU)),
        (lambda: jfr.clip_score(jnp.asarray(uint8_images(0, 1)), "a cat", image_encoder=j_img, text_encoder=j_txt),
         lambda: tfr.clip_score(torch.from_numpy(uint8_images(0, 1)), "a cat", image_encoder=t_img,
                                text_encoder=t_txt)),
    ]
    for jax_fn, torch_fn in cases:
        assert _warns(torch_fn) == _warns(jax_fn)


def test_entry_points_run_on_cuda_by_default(lpips_files, clip_encoders):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card behaviour cannot show here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ti.LearnedPerceptualImagePatchSimilarity(**lpips_files["alex"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lpips_fn.learned_perceptual_image_patch_similarity(np.zeros((1, 3, 8, 8), np.float32),
                                                             np.zeros((1, 3, 8, 8), np.float32),
                                                             **lpips_files["alex"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.CLIPScore(image_encoder=clip_encoders[1][0], text_encoder=clip_encoders[1][1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_clip.CLIPModel(text_layers=1, vision_layers=1)
