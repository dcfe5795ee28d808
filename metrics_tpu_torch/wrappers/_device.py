"""The device rule of the wrappers: a wrapper lives on its base metric's device.

``fleet_size`` passes through as the JAX package's wrappers take it: BootStrapper
stacks its copies under the fleet axis, MinMaxMetric keeps a running min and max per
stream, ClasswiseWrapper reads a fleet inner metric's per-stream values, and
MultioutputWrapper refuses it with the JAX package's message.
"""
from typing import Any, Dict

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import _same_device


def base_device_kwargs(wrapper: str, base_metric: Metric, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """``kwargs`` with ``device`` set to ``base_metric``'s; a ``device`` that names
    another raises."""
    device = kwargs.pop("device", None)
    if device is not None and not _same_device(torch.device(device), base_metric.device):
        raise ValueError(
            f"{wrapper}: `device` {device} differs from the base metric's device {base_metric.device};"
            " a wrapper lives on its base metric's device (move the base metric instead)"
        )
    return {**kwargs, "device": base_metric.device}
