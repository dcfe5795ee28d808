"""Root-functional shims of the audio functionals (counterpart of
``metrics_tpu/functional/audio/_deprecated.py``): called as
``metrics_tpu_torch.functional.<name>`` they warn (``FutureWarning``); from
``metrics_tpu_torch.functional.audio`` they stay silent.
"""
from metrics_tpu_torch.functional.audio import (
    permutation_invariant_training,
    pit_permutate,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_distortion_ratio,
    signal_noise_ratio,
)
from metrics_tpu_torch.utils.prints import _root_func_shim

_permutation_invariant_training = _root_func_shim(
    permutation_invariant_training, "permutation_invariant_training", "audio"
)
_pit_permutate = _root_func_shim(pit_permutate, "pit_permutate", "audio")
_scale_invariant_signal_distortion_ratio = _root_func_shim(
    scale_invariant_signal_distortion_ratio, "scale_invariant_signal_distortion_ratio", "audio"
)
_scale_invariant_signal_noise_ratio = _root_func_shim(
    scale_invariant_signal_noise_ratio, "scale_invariant_signal_noise_ratio", "audio"
)
_signal_distortion_ratio = _root_func_shim(signal_distortion_ratio, "signal_distortion_ratio", "audio")
_signal_noise_ratio = _root_func_shim(signal_noise_ratio, "signal_noise_ratio", "audio")

__all__ = [
    "_permutation_invariant_training",
    "_pit_permutate",
    "_scale_invariant_signal_distortion_ratio",
    "_scale_invariant_signal_noise_ratio",
    "_signal_distortion_ratio",
    "_signal_noise_ratio",
]
