"""Root-functional shims of the panoptic functionals (counterpart of
``metrics_tpu/functional/detection/_deprecated.py``): called as
``metrics_tpu_torch.functional.<name>`` they warn (``FutureWarning``); from
``metrics_tpu_torch.functional.detection`` they stay silent.
"""
from metrics_tpu_torch.functional.detection import modified_panoptic_quality, panoptic_quality
from metrics_tpu_torch.utils.prints import _root_func_shim

_modified_panoptic_quality = _root_func_shim(modified_panoptic_quality, "modified_panoptic_quality", "detection")
_panoptic_quality = _root_func_shim(panoptic_quality, "panoptic_quality", "detection")

__all__ = ["_modified_panoptic_quality", "_panoptic_quality"]
