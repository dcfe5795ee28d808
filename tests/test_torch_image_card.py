"""The image and pairwise slice on the card against the port's CPU run.

Every test here needs a CUDA card: each is marked ``cuda`` and skips elsewhere. The
file imports neither JAX nor metrics_tpu, so that it runs on a machine with the card
alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_image_card.py

Tolerances: Inception features within 1e-3 absolute (float32, TF32 off on the card);
SSIM, MS-SSIM and UQI within 1e-5 absolute; PSNR, FID and the pairwise functions
within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch import image as ti
from metrics_tpu_torch.functional import image as tfi
from metrics_tpu_torch.functional import pairwise as tp
from metrics_tpu_torch.models.inception import FeatureExtractorInceptionV3, random_inception_state
from tests.torch_deadline import deadline  # noqa: F401

TAPS = (64, 192, 768, 2048, "logits_unbiased")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # the port must choose float32 itself
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 299, 299), (2, 3, 67, 45), (3, 3, 32, 32)])
def test_inception_forward_on_card_matches_cpu(cuda, shape):
    state = random_inception_state(0)
    card, cpu = (FeatureExtractorInceptionV3(state=state, device=d) for d in (cuda, "cpu"))
    img = torch.from_numpy(np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8))
    for tap in TAPS:
        got = card(img.to(cuda), tap).cpu().numpy()
        np.testing.assert_allclose(got, cpu(img, tap).numpy(), rtol=0, atol=1e-3)


def _extractor(imgs):
    return imgs.reshape(imgs.shape[0], -1)[:, :24].to(torch.float32)


@pytest.mark.cuda
def test_fid_kid_is_on_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    real = torch.from_numpy(rng.rand(64, 3, 4, 4).astype(np.float32))
    fake = torch.from_numpy((rng.rand(64, 3, 4, 4) * 1.2 + 0.1).astype(np.float32))
    values = []
    for device in (cuda, "cpu"):
        fid = ti.FrechetInceptionDistance(feature=_extractor, device=device)
        kid = ti.KernelInceptionDistance(feature=_extractor, subsets=5, subset_size=32, device=device)
        inception = ti.InceptionScore(feature=_extractor, splits=4, device=device)
        for metric in (fid, kid):
            metric.update(real.to(device), real=True)
            metric.update(fake.to(device), real=False)
        inception.update(fake.to(device))
        np.random.seed(0)
        values.append([float(fid.compute()), *(float(v) for v in kid.compute()),
                       *(float(v) for v in inception.compute())])
    np.testing.assert_allclose(values[0], values[1], rtol=1e-5)


@pytest.mark.cuda
def test_ssim_family_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(3)
    target = torch.from_numpy(rng.rand(2, 3, 192, 200).astype(np.float32))
    preds = (target + 0.05 * torch.from_numpy(rng.randn(2, 3, 192, 200).astype(np.float32))).clamp(0, 1)
    for fn, atol, rtol in (
        (lambda p, t: tfi.structural_similarity_index_measure(p, t, data_range=1.0, reduction="none"), 1e-5, 0),
        (lambda p, t: tfi.multiscale_structural_similarity_index_measure(p, t, data_range=1.0), 1e-5, 0),
        (lambda p, t: tfi.universal_image_quality_index(p, t), 1e-5, 0),
        (lambda p, t: tfi.peak_signal_noise_ratio(p, t, data_range=1.0), 0, 1e-5),
        (lambda p, t: tfi.total_variation(p), 0, 1e-5),
    ):
        got = fn(preds.to(cuda), target.to(cuda)).cpu().numpy()
        np.testing.assert_allclose(got, fn(preds, target).numpy(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", tp.__all__)
def test_pairwise_on_card_matches_cpu(cuda, name):
    rng = np.random.RandomState(7)
    x, y = (torch.from_numpy((rng.randn(n, 64) * 2).astype(np.float32)) for n in (300, 200))
    got = getattr(tp, name)(x.to(cuda), y.to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, getattr(tp, name)(x, y).numpy(), rtol=1e-5, atol=1e-6)
