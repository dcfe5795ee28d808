"""Short-Time Objective Intelligibility (counterpart of ``metrics_tpu/functional/audio/stoi.py``).

The port's own copy of the JAX package's NumPy implementation of the published
algorithm (Taal, Hendriks, Heusdens, Jensen, "An Algorithm for Intelligibility
Prediction of Time-Frequency Weighted Noisy Speech", 2011):

1. resample both signals to 10 kHz (scipy's ``resample_poly``),
2. remove frames more than 40 dB below the loudest frame (256-sample hann frames,
   50% overlap, overlap-add reconstruction),
3. 512-point STFT (256-sample frames, 128 hop) -> 15 one-third-octave bands from
   150 Hz,
4. per 30-frame segment and band: scale the degraded segment to the clean energy,
   clip at -15 dB SDR, and correlate with the clean segment; average everything.

It runs on the host by nature: silent-frame removal gives data-dependent lengths.
Where the ``pystoi`` package is installed it is used instead. The extended variant
normalises deterministically (pystoi adds random dithering).
"""
import functools

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils import imports
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.prints import rank_zero_warn

FS = 10000  # sample rate of the algorithm
N_FRAME = 256  # silence-removal and STFT frame
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30  # frames per intelligibility segment
BETA = -15.0  # lower SDR clip (dB)
DYN_RANGE = 40.0
_EPS = np.finfo(np.float64).eps


@functools.lru_cache(maxsize=8)
def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: int) -> np.ndarray:
    """One-third-octave band matrix over the rfft bins."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_bin = int(np.argmin(np.square(f - freq_low[i])))
        fh_bin = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl_bin:fh_bin] = 1
    return obm


def _hann(framelen: int) -> np.ndarray:
    return np.hanning(framelen + 2)[1:-1]


def _frame(x: np.ndarray, framelen: int, hop: int) -> np.ndarray:
    starts = range(0, len(x) - framelen, hop)
    return np.array([x[i : i + framelen] for i in starts])


def _remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int):
    w = _hann(framelen)
    x_frames = _frame(x, framelen, hop) * w
    y_frames = _frame(y, framelen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    mask = (np.max(energies) - dyn_range - energies) < 0
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    if len(x_frames) == 0:
        return np.zeros(0), np.zeros(0)
    n_sil = (len(x_frames) - 1) * hop + framelen
    x_sil = np.zeros(n_sil)
    y_sil = np.zeros(n_sil)
    for i in range(len(x_frames)):
        x_sil[i * hop : i * hop + framelen] += x_frames[i]
        y_sil[i * hop : i * hop + framelen] += y_frames[i]
    return x_sil, y_sil


def _stft_bands(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """(bands, frames) one-third-octave magnitudes."""
    w = _hann(N_FRAME)
    frames = _frame(x, N_FRAME, N_FRAME // 2) * w
    spec = np.fft.rfft(frames, n=NFFT, axis=-1)
    return np.sqrt(obm @ np.square(np.abs(spec)).T)


def _segments(tob: np.ndarray, n: int) -> np.ndarray:
    """(num_segments, bands, n) sliding segments of n frames."""
    return np.array([tob[:, m - n : m] for m in range(n, tob.shape[1] + 1)])


def _stoi_numpy(clean: np.ndarray, degraded: np.ndarray, fs: int, extended: bool) -> float:
    if clean.shape != degraded.shape:
        raise ValueError("Clean and degraded signals must have the same shape")
    if fs != FS:
        if not imports._SCIPY_AVAILABLE:
            raise ModuleNotFoundError("Resampling to 10 kHz requires scipy.")
        from scipy.signal import resample_poly

        clean = resample_poly(clean, FS, fs)
        degraded = resample_poly(degraded, FS, fs)

    if len(clean) <= N_FRAME:
        rank_zero_warn(
            f"Signal too short for STOI ({len(clean)} <= {N_FRAME} samples at 10 kHz); returning 1e-5.",
            RuntimeWarning,
        )
        return 1e-5
    clean, degraded = _remove_silent_frames(clean, degraded, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if len(clean) < N_FRAME + 1:
        rank_zero_warn("Not enough non-silent frames to compute STOI; returning 1e-5.", RuntimeWarning)
        return 1e-5

    obm = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    x_tob = _stft_bands(clean, obm)
    y_tob = _stft_bands(degraded, obm)
    if x_tob.shape[1] < N_SEG:
        rank_zero_warn(
            f"Signal too short after silence removal ({x_tob.shape[1]} < {N_SEG} frames); returning 1e-5.",
            RuntimeWarning,
        )
        return 1e-5

    x_seg = _segments(x_tob, N_SEG)  # (M, bands, N)
    y_seg = _segments(y_tob, N_SEG)

    if extended:

        def _row_col_normalize(seg: np.ndarray) -> np.ndarray:
            seg = seg - np.mean(seg, axis=2, keepdims=True)
            seg = seg / (np.linalg.norm(seg, axis=2, keepdims=True) + _EPS)
            seg = seg - np.mean(seg, axis=1, keepdims=True)
            return seg / (np.linalg.norm(seg, axis=1, keepdims=True) + _EPS)

        x_n = _row_col_normalize(x_seg)
        y_n = _row_col_normalize(y_seg)
        return float(np.sum(x_n * y_n / N_SEG) / x_n.shape[0])

    norm_const = np.linalg.norm(x_seg, axis=2, keepdims=True) / (np.linalg.norm(y_seg, axis=2, keepdims=True) + _EPS)
    y_prim = np.minimum(y_seg * norm_const, x_seg * (1 + np.power(10.0, -BETA / 20)))

    y_prim = y_prim - np.mean(y_prim, axis=2, keepdims=True)
    x_cent = x_seg - np.mean(x_seg, axis=2, keepdims=True)
    y_prim = y_prim / (np.linalg.norm(y_prim, axis=2, keepdims=True) + _EPS)
    x_cent = x_cent / (np.linalg.norm(x_cent, axis=2, keepdims=True) + _EPS)
    correlations = np.sum(y_prim * x_cent, axis=2)  # (M, bands)
    return float(np.mean(correlations))


def short_time_objective_intelligibility(
    preds, target, fs: int, extended: bool = False, keep_same_device: bool = False, device=None
) -> Tensor:
    """STOI in about [0, 1] (higher is more intelligible), per signal over the trailing
    time axis, as float32 on the inputs' device; computed on the host.

    ``keep_same_device`` is accepted for API parity (the result is always on the
    inputs' device).
    """
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    if preds.shape != target.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")
    flat_p = preds.detach().to("cpu", torch.float64).numpy().reshape(-1, preds.shape[-1])
    flat_t = target.detach().to("cpu", torch.float64).numpy().reshape(-1, target.shape[-1])
    if imports._PYSTOI_AVAILABLE:
        from pystoi import stoi as _pystoi

        vals = [_pystoi(t, p, fs, extended=extended) for p, t in zip(flat_p, flat_t)]
    else:
        vals = [_stoi_numpy(t, p, fs, extended) for p, t in zip(flat_p, flat_t)]
    out = np.array(vals, dtype=np.float32).reshape(tuple(preds.shape[:-1]))
    return torch.as_tensor(out, device=preds.device)
