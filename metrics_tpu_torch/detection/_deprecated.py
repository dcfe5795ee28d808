"""Root-import shims of the panoptic metrics (counterpart of ``metrics_tpu/detection/_deprecated.py``):
built from the package root they warn (``FutureWarning``); from
``metrics_tpu_torch.detection`` they stay silent.
"""
from metrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality
from metrics_tpu_torch.utils.prints import _root_class_shim

_ModifiedPanopticQuality = _root_class_shim(ModifiedPanopticQuality, "ModifiedPanopticQuality", "detection", __name__)
_PanopticQuality = _root_class_shim(PanopticQuality, "PanopticQuality", "detection", __name__)

__all__ = ["_ModifiedPanopticQuality", "_PanopticQuality"]
