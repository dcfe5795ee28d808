"""SDR and SI-SDR (counterpart of ``metrics_tpu/functional/audio/sdr.py``).

SDR solves for the optimal length-``filter_length`` distortion filter that projects
``preds`` onto the shifted copies of ``target``: an FFT auto- and cross-correlation
(``torch.fft.rfft``/``irfft``), the symmetric Toeplitz matrix built by an ``|i - j|``
gather, and a batched ``torch.linalg.solve``. It computes in float64 on the inputs'
device whatever their dtype, as the reference torchmetrics does (the JAX package
computes in float32 unless x64 is on), and returns the input dtype. The coherence is
clamped below 1, so a perfect estimate reads 156.5 dB and not NaN.
"""
import math
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix ``M[..., i, j] = vector[..., |i - j|]``."""
    n = vector.shape[-1]
    idx = torch.arange(n, device=vector.device)
    return vector[..., (idx[:, None] - idx[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int):
    """FFT autocorrelation of ``target`` and its cross-correlation with ``preds``, first ``corr_len`` lags."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds, target, use_cg_iter: Optional[int] = None, filter_length: int = 512, zero_mean: bool = False,
    load_diag: Optional[float] = None, device=None,
) -> Tensor:
    """Signal-to-distortion ratio in dB, per sample over the trailing time axis.

    ``use_cg_iter`` is accepted for API parity and ignored (warning): the dense
    Toeplitz solve is used.
    """
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    out_dtype = preds.dtype
    preds = preds.to(torch.float64)
    target = target.to(torch.float64)

    if use_cg_iter is not None:
        rank_zero_warn(
            "`use_cg_iter` is accepted for API parity but ignored: the dense Toeplitz solve is used.",
            UserWarning,
        )

    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = r_0.clone()
        r_0[..., 0] += load_diag

    r = _symmetric_toeplitz(r_0)
    sol = torch.linalg.solve(r, b[..., None])[..., 0]

    coh = torch.einsum("...l,...l->...", b, sol)
    # A perfect or scaled estimate has coh = 1, which rounding can leave at or just
    # above 1, where coh / (1 - coh) is inf or negative and its log NaN. Clamped, such
    # an estimate reads 10 log10((1 - eps) / eps) = 156.5 dB (a deliberate deviation:
    # the JAX package gives inf, NaN or that value, as the rounding falls).
    coh = torch.clamp(coh, max=1 - torch.finfo(torch.float64).eps)
    ratio = coh / (1 - coh)
    return (10.0 * torch.log10(ratio)).to(out_dtype)


def scale_invariant_signal_distortion_ratio(preds, target, zero_mean: bool = False, device=None) -> Tensor:
    """Scale-invariant SDR in dB, per sample over the trailing time axis."""
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)
