"""Shared helpers of the image tests (``tests/test_torch_image.py`` and
``tests/test_torch_image_classes.py``): seeded inputs and the comparisons."""
import numpy as np
import torch

ABS = 1e-5
REL = 1e-5


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol=0.0, rtol=0.0):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, atol, rtol)
        return
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol)


def images(seed, shape=(2, 3, 32, 32), noise=0.1, offset=0.0):
    rng = np.random.RandomState(seed)
    target = (rng.rand(*shape) + offset).astype(np.float32)
    preds = np.clip(target + noise * rng.randn(*shape), offset, 1 + offset).astype(np.float32)
    return preds, target


def assert_angles_close(got, want):
    """Per-pixel angles: the arccos of a float32 cosine near 1 turns its last-bit
    rounding into 1/sin(angle) times as much. ``dot / (|p| |t|)`` rounds five times
    (dot, two norms, product, quotient), so each package's cosine lies within ~4 ulps
    (2^-24 each) of the exact one: each angle holds 1e-5 relative plus 8 ulps of the
    cosine over sin(angle)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    bound = REL * np.abs(want) + 8 * 2.0**-24 / np.sin(want)
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) / bound)
