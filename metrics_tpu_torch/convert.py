"""Carry a ``metrics_tpu`` metric's state into the port: the port's counterpart of
carrying weights across.

The JAX package's ``Metric.state_dict()`` gives numpy arrays (only for persistent
states, so call ``persistent(True)`` on it first). Without ``jax_enable_x64`` its
count states are float32; the port's are int64. :func:`load_jax_state` converts
each state to the port's dtype and device, and refuses float counts that are not
whole numbers rather than rounding them. A ``CatBuffer`` state comes as the JAX
package's ``{"data", "count", "overflow"}`` dict and stays a ``CatBuffer``.
"""
from typing import Any, Dict

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer


def _as_state_tensor(name: str, value: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    array = np.asarray(value)
    if not dtype.is_floating_point and np.issubdtype(array.dtype, np.floating):
        if not np.all(np.isfinite(array)) or not np.array_equal(array, np.round(array)):
            raise ValueError(f"load_jax_state: state `{name}` holds non-integral values for an integer state")
        array = np.round(array).astype(np.int64)
    return torch.tensor(array).to(device=device, dtype=dtype)


def load_jax_state(metric: Metric, state: Dict[str, Any]) -> Metric:
    """Load ``state`` (a ``metrics_tpu`` ``state_dict()``: name -> numpy array or list
    of arrays) into ``metric``, replacing its states, and return ``metric``.

    Every state of ``metric`` must be present with the same shape. Tensor states take
    the port's dtype (float32 counts become int64); list (``cat``) states take the
    items as they are, integers widened to int64. A ``CatBuffer`` entry (a dict of
    ``data``, ``count`` and ``overflow``) becomes a ``CatBuffer`` of the same fields,
    its data in the dtype the metric declared for the state.
    """
    missing = sorted(set(metric._defaults) - set(state))
    if missing:
        raise KeyError(f"load_jax_state: state dict lacks {missing} (call persistent(True) before state_dict())")
    for name, default in metric._defaults.items():
        value = state[name]
        if isinstance(value, dict):
            if not {"data", "count"} <= set(value):
                raise ValueError(f"load_jax_state: state `{name}` is a dict without `data` and `count`")
            # a list state loads as a buffer too, in its declared row dtype
            dtype = default.data.dtype if isinstance(default, CatBuffer) else metric._cat_meta.get(name, ((), None))[1]
            data = np.asarray(value["data"])
            data = torch.tensor(data, device=metric.device) if dtype is None else _as_state_tensor(
                name, data, dtype, metric.device
            )
            setattr(metric, name, CatBuffer(data, np.asarray(value["count"]), np.asarray(value.get("overflow", False))))
        elif isinstance(default, list):
            items = []
            for item in value:
                item = np.asarray(item)
                dtype = torch.int64 if np.issubdtype(item.dtype, np.integer) else torch.from_numpy(item).dtype
                items.append(_as_state_tensor(name, item, dtype, metric.device))
            setattr(metric, name, items)
        else:
            tensor = _as_state_tensor(name, value, default.dtype, metric.device)
            if tensor.shape != default.shape:
                raise ValueError(
                    f"load_jax_state: state `{name}` has shape {tuple(tensor.shape)}, expected {tuple(default.shape)}"
                )
            setattr(metric, name, tensor)
    metric._computed = None
    return metric
