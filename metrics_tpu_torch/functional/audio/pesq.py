"""PESQ (counterpart of ``metrics_tpu/functional/audio/pesq.py``).

PESQ (ITU-T P.862) delegates to the ``pesq`` package, as the JAX package and the
reference do; without it the call raises the JAX package's ``ModuleNotFoundError``.
The standard's numeric tables exist only in the ITU's sources, so there is no port
of the algorithm itself.
"""
import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils import imports
from metrics_tpu_torch.utils.data import to_tensor


def _check_pesq_args(fs: int, mode: str) -> None:
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")


def perceptual_evaluation_speech_quality(
    preds, target, fs: int, mode: str, keep_same_device: bool = False, n_processes: int = 1, device=None
) -> Tensor:
    """PESQ MOS-LQO per signal (needs the ``pesq`` package), as float32 on the inputs' device.

    ``fs`` is 8000 (``"nb"``) or 16000; ``keep_same_device`` is accepted for API parity.
    """
    if not imports._PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that `pesq` is installed. Either install as `pip install pesq`, or use the "
            "host environment that bundles it. A from-scratch port is not provided because only the ITU "
            "reference implementation produces comparable MOS-LQO values."
        )
    import pesq as pesq_backend

    _check_pesq_args(fs, mode)
    if fs == 8000 and mode == "wb":
        raise ValueError("Expected argument `mode` to be 'nb' when `fs=8000`")

    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds_np = preds.detach().to("cpu", torch.float32).numpy()
    target_np = target.detach().to("cpu", torch.float32).numpy()
    if preds_np.shape != target_np.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")

    if preds_np.ndim == 1:
        out = np.array(pesq_backend.pesq(fs, target_np, preds_np, mode), np.float32)
    else:
        flat_p = preds_np.reshape(-1, preds_np.shape[-1])
        flat_t = target_np.reshape(-1, target_np.shape[-1])
        if n_processes > 1:
            vals = pesq_backend.pesq_batch(fs, flat_t, flat_p, mode, n_processor=n_processes)
        else:
            vals = [pesq_backend.pesq(fs, t, p, mode) for p, t in zip(flat_p, flat_t)]
        out = np.array(vals, np.float32).reshape(preds_np.shape[:-1])
    return torch.as_tensor(out, device=preds.device)
