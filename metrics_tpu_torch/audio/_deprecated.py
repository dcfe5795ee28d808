"""Root-import shims of the audio metrics (counterpart of ``metrics_tpu/audio/_deprecated.py``):
built from the package root they warn (``FutureWarning``); from
``metrics_tpu_torch.audio`` they stay silent.
"""
from metrics_tpu_torch.audio import (
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.utils.prints import _root_class_shim

_PermutationInvariantTraining = _root_class_shim(
    PermutationInvariantTraining, "PermutationInvariantTraining", "audio", __name__
)
_ScaleInvariantSignalDistortionRatio = _root_class_shim(
    ScaleInvariantSignalDistortionRatio, "ScaleInvariantSignalDistortionRatio", "audio", __name__
)
_ScaleInvariantSignalNoiseRatio = _root_class_shim(
    ScaleInvariantSignalNoiseRatio, "ScaleInvariantSignalNoiseRatio", "audio", __name__
)
_SignalDistortionRatio = _root_class_shim(SignalDistortionRatio, "SignalDistortionRatio", "audio", __name__)
_SignalNoiseRatio = _root_class_shim(SignalNoiseRatio, "SignalNoiseRatio", "audio", __name__)

__all__ = [
    "_PermutationInvariantTraining",
    "_ScaleInvariantSignalDistortionRatio",
    "_ScaleInvariantSignalNoiseRatio",
    "_SignalDistortionRatio",
    "_SignalNoiseRatio",
]
