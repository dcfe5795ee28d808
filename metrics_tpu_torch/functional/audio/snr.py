"""SNR and SI-SNR (counterpart of ``metrics_tpu/functional/audio/snr.py``)."""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor


def signal_noise_ratio(preds, target, zero_mean: bool = False, device=None) -> Tensor:
    """Signal-to-noise ratio in dB, per sample over the trailing time axis."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds, target, device=None) -> Tensor:
    """Scale-invariant SNR in dB (SI-SDR of zero-mean signals)."""
    from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio

    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True, device=device)
