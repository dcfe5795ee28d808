"""The image functionals of metrics_tpu_torch against metrics_tpu, on the CPU: SSIM
and MS-SSIM (2-D and 3-D), the PSNR family (PSNR, PSNRB, UQI, D-lambda, ERGAS, RASE,
RMSE-SW, SAM, TV) and image gradients, over their arguments, and their errors. The
classes, the states carried across and the exports are in
``tests/test_torch_image_classes.py``; the helpers in ``tests/torch_image_helpers.py``.

The same numpy inputs, drawn from seeded ``np.random.RandomState``s, go through the
JAX package and the port (``device="cpu"``). Tolerances: the SSIM family, UQI and
D-lambda within 1e-5 absolute (a ``sum`` reduction within 1e-5 for each summed
value); PSNR, PSNRB, ERGAS, RASE, RMSE-SW, SAM and TV within 1e-5 relative, SAM's
per-pixel angles within that plus 8 ulps of their cosine (``assert_angles_close``) (the JAX package blurs with banded matmuls, the port
with grouped convolutions, so the float32 sums run in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.image as jfi
import metrics_tpu_torch.functional.image as tfi
from tests.torch_image_helpers import ABS, REL, assert_angles_close, assert_close, images
from tests.torch_deadline import deadline  # noqa: F401

# ---------------------------------------------------------------------- SSIM

SSIM_CASES = [
    {},
    {"data_range": 1.0},
    {"data_range": (0.1, 0.9)},
    {"gaussian_kernel": False, "kernel_size": 7},
    {"gaussian_kernel": False, "kernel_size": (5, 9)},
    {"sigma": (1.0, 2.0)},
    {"sigma": 0.8, "data_range": 1.0, "k1": 0.02, "k2": 0.05},
    {"reduction": "sum", "data_range": 1.0},
    {"reduction": "none", "data_range": 1.0},
    {"return_full_image": True, "data_range": 1.0},
    {"return_contrast_sensitivity": True, "data_range": 1.0},
    {"reduction": "none", "return_contrast_sensitivity": True, "gaussian_kernel": False, "kernel_size": 5},
]


@pytest.mark.parametrize("kwargs", SSIM_CASES, ids=str)
def test_ssim_functional(kwargs):
    preds, target = images(0)
    want = jfi.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tfi.structural_similarity_index_measure(preds, target, **kwargs, device="cpu")
    assert_close(got, want, atol=ABS)


SSIM_3D_CASES = [
    {"data_range": 1.0},
    {"gaussian_kernel": False, "kernel_size": 3},
    {"gaussian_kernel": False, "kernel_size": (3, 5, 3), "reduction": "none"},
    {"sigma": (0.8, 1.0, 0.6), "return_contrast_sensitivity": True},
    {"sigma": 0.7, "return_full_image": True, "data_range": (0.0, 1.0)},
]


@pytest.mark.parametrize("kwargs", SSIM_3D_CASES, ids=str)
def test_ssim_3d_functional(kwargs):
    preds, target = images(1, (2, 2, 12, 14, 16))
    want = jfi.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tfi.structural_similarity_index_measure(preds, target, **kwargs, device="cpu")
    assert_close(got, want, atol=ABS)


MS_SSIM_CASES = [
    ((1, 3, 176, 176), {}),
    ((2, 1, 176, 176), {"data_range": 1.0, "normalize": "simple", "reduction": "none"}),
    ((1, 3, 176, 176), {"normalize": None, "data_range": 1.0, "reduction": "sum"}),
    ((2, 3, 64, 64), {"betas": (0.2, 0.3, 0.5), "kernel_size": 7, "sigma": 1.0, "gaussian_kernel": False}),
    ((2, 3, 64, 64), {"betas": (0.2, 0.3, 0.5), "sigma": (1.0, 0.8), "data_range": (0.05, 0.95)}),
    ((2, 1, 16, 16, 16), {"betas": (0.3, 0.7), "kernel_size": 3, "sigma": 0.5, "data_range": 1.0}),
]


@pytest.mark.parametrize("shape,kwargs", MS_SSIM_CASES, ids=str)
def test_ms_ssim_functional(shape, kwargs):
    preds, target = images(2, shape, noise=0.05)
    want = jfi.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tfi.multiscale_structural_similarity_index_measure(preds, target, **kwargs, device="cpu")
    assert_close(got, want, atol=ABS)


@pytest.mark.parametrize(
    "fn,kwargs,error",
    [
        ("ssim", {"kernel_size": 4}, "odd positive"),
        ("ssim", {"sigma": -1.0}, "positive number"),
        ("ssim", {"kernel_size": (3, 3, 3)}, "dimension"),
        ("ssim", {"return_full_image": True, "return_contrast_sensitivity": True}, "mutually exclusive"),
        ("ms_ssim", {"betas": (1, 2)}, "tuple of floats"),
        ("ms_ssim", {"normalize": "bad"}, "normalize"),
        ("ms_ssim", {}, "larger than"),
    ],
)
def test_ssim_errors_match(fn, kwargs, error):
    preds, target = images(3)
    name = {"ssim": "structural_similarity_index_measure", "ms_ssim": "multiscale_structural_similarity_index_measure"}
    for module, array in ((jfi, jnp.asarray), (tfi, torch.from_numpy)):
        with pytest.raises(ValueError, match=error):
            getattr(module, name[fn])(array(preds), array(target), **kwargs)


# ----------------------------------------------------------------- PSNR family

PSNR_CASES = [
    {},
    {"data_range": 2.0},
    {"data_range": (0.1, 0.8)},
    {"base": 2.718281828459045, "data_range": 1.0},
    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
    {"data_range": 1.0, "dim": 1, "reduction": "sum"},
    {"data_range": 1.0, "dim": (2, 3)},
]


@pytest.mark.parametrize("kwargs", PSNR_CASES, ids=str)
def test_psnr_functional(kwargs):
    preds, target = images(4)
    want = jfi.peak_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tfi.peak_signal_noise_ratio(preds, target, **kwargs, device="cpu")
    assert_close(got, want, rtol=REL)


@pytest.mark.parametrize("block_size", [8, 4, 5])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_psnrb_functional(block_size, scale):
    preds, target = images(5, (3, 1, 32, 40))
    preds, target = preds * scale, target * scale
    want = jfi.peak_signal_noise_ratio_with_blocked_effect(jnp.asarray(preds), jnp.asarray(target), block_size)
    got = tfi.peak_signal_noise_ratio_with_blocked_effect(preds, target, block_size, device="cpu")
    assert_close(got, want, rtol=REL)


def test_psnrb_rejects_colour_images_in_both():
    preds, target = images(5)
    for module, array in ((jfi, jnp.asarray), (tfi, torch.from_numpy)):
        with pytest.raises(ValueError, match="grayscale"):
            module.peak_signal_noise_ratio_with_blocked_effect(array(preds), array(target))


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"kernel_size": (7, 5), "sigma": (1.0, 2.0)}, {"reduction": "sum"}, {"reduction": "none"}],
    ids=str,
)
def test_uqi_functional(kwargs):
    preds, target = images(6)
    want = jfi.universal_image_quality_index(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tfi.universal_image_quality_index(preds, target, **kwargs, device="cpu")
    # a sum over the map: 1e-5 for each of its values
    summed = 1 if kwargs.get("reduction") != "sum" else 2 * 3 * 22 * 22
    assert_close(got, want, atol=ABS * summed)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_d_lambda_functional(p):
    preds, target = images(7, (2, 4, 24, 24))
    want = jfi.spectral_distortion_index(jnp.asarray(preds), jnp.asarray(target), p=p)
    got = tfi.spectral_distortion_index(preds, target, p=p, device="cpu")
    assert_close(got, want, atol=ABS)


@pytest.mark.parametrize("ratio", [4, 2.5])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ergas_functional(ratio, reduction):
    preds, target = images(8, offset=0.2)
    want = jfi.error_relative_global_dimensionless_synthesis(jnp.asarray(preds), jnp.asarray(target), ratio, reduction)
    got = tfi.error_relative_global_dimensionless_synthesis(preds, target, ratio, reduction, device="cpu")
    assert_close(got, want, rtol=REL)


@pytest.mark.parametrize("window_size", [8, 5, 3])
def test_rase_functional(window_size):
    preds, target = images(9, offset=0.2)
    want = jfi.relative_average_spectral_error(jnp.asarray(preds), jnp.asarray(target), window_size)
    got = tfi.relative_average_spectral_error(preds, target, window_size, device="cpu")
    assert_close(got, want, rtol=REL)


@pytest.mark.parametrize("window_size", [8, 4, 3])
@pytest.mark.parametrize("return_rmse_map", [False, True])
def test_rmse_sw_functional(window_size, return_rmse_map):
    preds, target = images(10)
    want = jfi.root_mean_squared_error_using_sliding_window(
        jnp.asarray(preds), jnp.asarray(target), window_size, return_rmse_map
    )
    got = tfi.root_mean_squared_error_using_sliding_window(preds, target, window_size, return_rmse_map, device="cpu")
    assert_close(got, want, rtol=REL, atol=1e-7)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_functional(reduction):
    preds, target = images(11, (2, 5, 16, 16))
    want = jfi.spectral_angle_mapper(jnp.asarray(preds), jnp.asarray(target), reduction)
    got = tfi.spectral_angle_mapper(preds, target, reduction, device="cpu")
    if reduction == "none":
        assert_angles_close(got, want)
    else:
        assert_close(got, want, rtol=REL)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_tv_functional(reduction):
    img, _ = images(12)
    want = jfi.total_variation(jnp.asarray(img), reduction)
    got = tfi.total_variation(img, reduction, device="cpu")
    assert_close(got, want, rtol=REL)


def test_image_gradients_functional():
    img, _ = images(13, (2, 3, 9, 7))
    want = jfi.image_gradients(jnp.asarray(img))
    got = tfi.image_gradients(img, device="cpu")
    assert_close(got, want, atol=0.0)


@pytest.mark.parametrize(
    "name,args",
    [
        ("spectral_angle_mapper", ((2, 1, 8, 8),)),
        ("total_variation", ((2, 8, 8),)),
        ("image_gradients", ((2, 8, 8),)),
        ("universal_image_quality_index", ((2, 8, 8),)),
        ("error_relative_global_dimensionless_synthesis", ((2, 8, 8),)),
    ],
)
def test_shape_errors_match(name, args):
    shape = args[0]
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    inputs = (x,) if name in ("total_variation", "image_gradients") else (x, x)
    errors = []
    for module, array in ((jfi, jnp.asarray), (tfi, torch.from_numpy)):
        with pytest.raises((ValueError, RuntimeError)) as info:
            getattr(module, name)(*(array(a) for a in inputs))
        errors.append(info.type)
    assert errors[0] is errors[1]
