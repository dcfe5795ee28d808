"""The image metric classes of metrics_tpu_torch against metrics_tpu, on the CPU: each
class over three updates through ``forward`` (batch values compared), ``compute``,
``reset`` and one more update; the states of an updated JAX metric carried across
with ``load_jax_state``; every public name of ``metrics_tpu.image``,
``functional.image`` and ``functional.pairwise`` in the port; the root exports and
their ``FutureWarning`` shims (LPIPS's class with its weights in
``tests/test_torch_model_image.py``).

Tolerances as in ``tests/test_torch_image.py``.
"""
import warnings

import jax.numpy as jnp
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jfr
import metrics_tpu.functional.image as jfi
import metrics_tpu.image as ji
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.image as tfi
import metrics_tpu_torch.image as ti
from metrics_tpu_torch.convert import load_jax_state
from tests.torch_image_helpers import ABS, REL, assert_angles_close, assert_close, images
from tests.torch_deadline import deadline  # noqa: F401

# classes whose constructor without arguments raises ModuleNotFoundError in both packages
# (no weight files), which the shim-warning check does not catch; their root names are
# held with weights in tests/test_torch_model_image.py
NEEDS_WEIGHT_FILES = {"LearnedPerceptualImagePatchSimilarity"}


# -------------------------------------------------------------------- classes


def run_class(jmetric, tmetric, batches, forward=True):
    """Forward (or update) every batch through both, compare the batch values, then
    compute; reset; one more update and compute."""
    for batch in batches:
        if forward:
            want = jmetric(*(jnp.asarray(b) for b in batch))
            got = tmetric(*(torch.from_numpy(b) for b in batch))
            yield "forward", got, want
        else:
            jmetric.update(*(jnp.asarray(b) for b in batch))
            tmetric.update(*(torch.from_numpy(b) for b in batch))
    yield "compute", tmetric.compute(), jmetric.compute()
    jmetric.reset()
    tmetric.reset()
    jmetric.update(*(jnp.asarray(b) for b in batches[0]))
    tmetric.update(*(torch.from_numpy(b) for b in batches[0]))
    yield "after reset", tmetric.compute(), jmetric.compute()


def batches_of(n, seed, shape=(2, 3, 32, 32), **kwargs):
    return [images(seed + i, shape, **kwargs) for i in range(n)]


CLASS_CASES = [
    ("StructuralSimilarityIndexMeasure", {}, {}, ABS, 0),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "reduction": "sum"}, {}, ABS, 0),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "reduction": "none"}, {}, ABS, 0),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0, "return_full_image": True}, {}, ABS, 0),
    ("StructuralSimilarityIndexMeasure", {"gaussian_kernel": False, "kernel_size": 5,
                                          "return_contrast_sensitivity": True}, {}, ABS, 0),
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}, {"shape": (2, 1, 12, 12, 12)}, ABS, 0),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"data_range": 1.0}, {"shape": (1, 3, 176, 176)}, ABS, 0),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"data_range": 1.0, "betas": (0.4, 0.6), "reduction": "none"},
     {"shape": (2, 3, 48, 48)}, ABS, 0),
    ("PeakSignalNoiseRatio", {}, {}, 0, REL),
    ("PeakSignalNoiseRatio", {"data_range": (0.1, 0.9), "base": 2.0}, {}, 0, REL),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, {}, 0, REL),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, {"shape": (2, 1, 32, 32)}, 0, REL),
    ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 4}, {"shape": (2, 1, 24, 32)}, 0, REL),
    ("UniversalImageQualityIndex", {}, {}, ABS, 0),
    # a sum over three batches' maps: 1e-5 for each of its 3 x 2 x 3 x 22 x 22 values
    ("UniversalImageQualityIndex", {"reduction": "sum"}, {}, ABS * 8712, 0),
    ("UniversalImageQualityIndex", {"reduction": "none", "kernel_size": (5, 5)}, {}, ABS, 0),
    ("SpectralDistortionIndex", {"p": 2}, {"shape": (2, 3, 24, 24)}, ABS, 0),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, {"offset": 0.2}, 0, REL),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2, "reduction": "none"}, {"offset": 0.2}, 0, REL),
    ("RelativeAverageSpectralError", {}, {"offset": 0.2}, 0, REL),
    ("RelativeAverageSpectralError", {"window_size": 5}, {"offset": 0.2}, 0, REL),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, {}, 0, REL),
    ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 3}, {}, 0, REL),
    ("SpectralAngleMapper", {}, {}, 0, REL),
    ("SpectralAngleMapper", {"reduction": "none"}, {}, None, None),
    ("TotalVariation", {}, {}, 0, REL),
    ("TotalVariation", {"reduction": "mean"}, {}, 0, REL),
    ("TotalVariation", {"reduction": "none"}, {}, 0, REL),
]


@pytest.mark.parametrize("name,kwargs,data,atol,rtol", CLASS_CASES, ids=lambda v: str(v) if not isinstance(v, float) else "")
def test_class_updates_forward_reset(name, kwargs, data, atol, rtol):
    batches = batches_of(3, 20, **data)
    if name == "TotalVariation":
        batches = [(b[0],) for b in batches]
    jmetric = getattr(ji, name)(**kwargs)
    tmetric = getattr(ti, name)(**kwargs, device="cpu")
    for label, got, want in run_class(jmetric, tmetric, batches):
        try:
            if atol is None:
                assert_angles_close(got, want)
            else:
                assert_close(got, want, atol=atol, rtol=rtol)
        except AssertionError as err:
            raise AssertionError(f"{label}: {err}") from None


@pytest.mark.parametrize(
    "name,kwargs,data",
    [
        ("PeakSignalNoiseRatio", {}, {}),
        ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": 1}, {}),
        ("StructuralSimilarityIndexMeasure", {"reduction": "none"}, {}),
        ("UniversalImageQualityIndex", {"reduction": "none"}, {}),
        ("RelativeAverageSpectralError", {}, {"offset": 0.2}),
        ("RootMeanSquaredErrorUsingSlidingWindow", {}, {}),
        ("TotalVariation", {"reduction": "none"}, {}),
        ("PeakSignalNoiseRatioWithBlockedEffect", {}, {"shape": (2, 1, 16, 16)}),
    ],
)
def test_load_jax_state_of_image_metrics(name, kwargs, data):
    """States of an updated JAX metric, loaded into the port, compute the same value."""
    batches = batches_of(2, 40, **data)
    if name == "TotalVariation":
        batches = [(b[0],) for b in batches]
    jmetric = getattr(ji, name)(**kwargs)
    for batch in batches:
        jmetric.update(*(jnp.asarray(b) for b in batch))
    jmetric.persistent(True)
    tmetric = load_jax_state(getattr(ti, name)(**kwargs, device="cpu"), jmetric.state_dict())
    assert_close(tmetric.compute(), jmetric.compute(), atol=ABS, rtol=REL)


# ----------------------------------------------------------- exports and names


@pytest.mark.parametrize(
    "module,port",
    [(ji, ti), (jfi, tfi), (metrics_tpu.functional.pairwise, metrics_tpu_torch.functional.pairwise)],
    ids=["image", "functional.image", "functional.pairwise"],
)
def test_every_public_name_exists_in_the_port(module, port):
    names = set(module.__all__)
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing
    assert set(port.__all__) == names


def test_root_exports_match_the_jax_root_for_image_and_pairwise():
    image_names = set(ji.__all__)
    assert image_names <= set(metrics_tpu_torch.__all__)
    for name in image_names:
        assert (name in metrics_tpu.__all__) == (name in metrics_tpu_torch.__all__), name
    functional_names = set(jfi.__all__) | set(metrics_tpu.functional.pairwise.__all__)
    assert functional_names <= set(tfr.__all__)
    assert functional_names <= set(jfr.__all__)


@pytest.mark.parametrize("name", sorted(set(ji.__all__) - NEEDS_WEIGHT_FILES))
def test_root_class_shims_warn_as_in_jax(name):
    kwargs = {"feature": lambda x: x.reshape(x.shape[0], -1)[:, :4]} if "Inception" in name else {}
    jax_warns = _warns(lambda: getattr(metrics_tpu, name)(**kwargs))
    assert _warns(lambda: getattr(metrics_tpu_torch, name)(**kwargs, device="cpu")) == jax_warns
    assert not _warns(lambda: getattr(ti, name)(**kwargs, device="cpu"))


@pytest.mark.parametrize("name", sorted(jfi.__all__))
def test_root_functional_shims_warn_as_in_jax(name):
    img, _ = images(14, (1, 1, 16, 16))
    args = (img,) if name in ("total_variation", "image_gradients") else (img, img)
    jax_warns = _warns(lambda: getattr(jfr, name)(*(jnp.asarray(a) for a in args)))
    assert _warns(lambda: getattr(tfr, name)(*(torch.from_numpy(a) for a in args))) == jax_warns
    assert not _warns(lambda: getattr(tfi, name)(*(torch.from_numpy(a) for a in args)))


def _warns(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            fn()
        except ValueError:
            pass  # a functional whose size checks refuse the tiny input has warned already
    return any(issubclass(w.category, FutureWarning) for w in caught)
