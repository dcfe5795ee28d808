"""The device rule of the wrappers: a wrapper lives on its base metric's device.

The wrappers refuse ``fleet_size``: their stacked fleet paths (BootStrapper's
stacked launch, MultioutputWrapper's vmapped outputs, ClasswiseWrapper's fleet
branch) are not ported yet, where the JAX ``BootStrapper`` accepts it.
"""
from typing import Any, Dict

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import _same_device


def base_device_kwargs(wrapper: str, base_metric: Metric, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``kwargs`` with ``device`` set to ``base_metric``'s; a ``device`` that names
    another raises, and so does ``fleet_size``."""
    if "fleet_size" in kwargs:
        raise ValueError(f"{wrapper}: `fleet_size` is not supported by the port's wrappers yet")
    device = kwargs.pop("device", None)
    if device is not None and not _same_device(torch.device(device), base_metric.device):
        raise ValueError(
            f"{wrapper}: `device` {device} differs from the base metric's device {base_metric.device};"
            " a wrapper lives on its base metric's device (move the base metric instead)"
        )
    return {**kwargs, "device": base_metric.device}
