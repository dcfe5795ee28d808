"""Carry a ``metrics_tpu`` metric's state into the port: the port's counterpart of
carrying weights across.

The JAX package's ``Metric.state_dict()`` gives numpy arrays (only for persistent
states, so call ``persistent(True)`` on it first). Without ``jax_enable_x64`` its
count states are float32; the port's are int64. :func:`load_jax_state` converts
each state to the port's dtype and device, and refuses float counts that are not
whole numbers rather than rounding them. A ``CatBuffer`` state comes as the JAX
package's ``{"data", "count", "overflow"}`` dict and stays a ``CatBuffer``.

A ``MetricCollection`` takes a ``metrics_tpu`` collection's ``state_dict()``, whose
keys are ``"<name>.<state>"``: each compute group's state is loaded once, into its
leader, and shared with the members again.

A state with ``dist_reduce_fx=None`` may come stacked, as a sync leaves it (a leading
process axis, e.g. FID's ``(k, D)`` means); FID's lazily sized moments are sized from
the incoming ones, and the sliding-window maps of RASE and RMSE-SW take the shape they
come with.

:func:`inception_state_from_jax` carries weights across: the JAX InceptionV3's
parameter pytree becomes the state dict of
:class:`~metrics_tpu_torch.models.inception.FeatureExtractorInceptionV3`.
"""
from typing import Any, Dict, Union

import numpy as np
import torch

from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer


def _as_state_tensor(name: str, value: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    array = np.asarray(value)
    if not dtype.is_floating_point and np.issubdtype(array.dtype, np.floating):
        if not np.all(np.isfinite(array)) or not np.array_equal(array, np.round(array)):
            raise ValueError(f"load_jax_state: state `{name}` holds non-integral values for an integer state")
        array = np.round(array).astype(np.int64)
    return torch.tensor(array).to(device=device, dtype=dtype)


def load_jax_state(metric: Union[Metric, MetricCollection], state: Dict[str, Any]) -> Union[Metric, MetricCollection]:
    """Load ``state`` (a ``metrics_tpu`` ``state_dict()``: name -> numpy array or list
    of arrays) into ``metric``, replacing its states, and return ``metric``.

    For a collection, ``state`` is the collection's ``state_dict()`` and every
    metric's part of it (``"<name>."`` keys) loads as below: a group's leader's
    part once, shared by the members, the others each their own.

    Every state of ``metric`` must be present with the same shape. Tensor states take
    the port's dtype (float32 counts become int64); list (``cat``) states take the
    items as they are, integers widened to int64. A ``CatBuffer`` entry (a dict of
    ``data``, ``count`` and ``overflow``) becomes a ``CatBuffer`` of the same fields,
    its data in the dtype the metric declared for the state.
    """
    if isinstance(metric, MetricCollection):
        return _load_collection(metric, state)
    if hasattr(metric, "_init_states_for_load"):
        metric._init_states_for_load(state)
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
            stacked = metric._reductions[name] is None and tensor.shape[1:] == default.shape
            if tensor.shape != default.shape and not stacked and not getattr(metric, "_lazy_state_shapes", False):
                raise ValueError(
                    f"load_jax_state: state `{name}` has shape {tuple(tensor.shape)}, expected {tuple(default.shape)}"
                )
            setattr(metric, name, tensor)
    metric._computed = None
    return metric


_BN_NAMES = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def inception_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``FeatureExtractorInceptionV3`` from the JAX package's InceptionV3
    parameter pytree (``random_inception_params`` or ``params_from_state_dict``), whose
    leaves are arrays: ``{block: {"kernel", "bn_*"}}`` for the stem convs,
    ``{block: {branch: {...}}}`` for the mixed blocks and ``{"fc": {"weight", "bias"}}``."""
    state: Dict[str, torch.Tensor] = {}

    def conv_bn(prefix: str, leaves: Dict[str, Any]) -> None:
        state[f"{prefix}.conv.weight"] = torch.tensor(np.asarray(leaves["kernel"]))
        for key, name in _BN_NAMES.items():
            state[f"{prefix}.{name}"] = torch.tensor(np.asarray(leaves[key]))

    for block, leaves in params.items():
        if block == "fc":
            state["fc.weight"] = torch.tensor(np.asarray(leaves["weight"]))
            state["fc.bias"] = torch.tensor(np.asarray(leaves["bias"]))
        elif "kernel" in leaves:
            conv_bn(block, leaves)
        else:
            for branch, branch_leaves in leaves.items():
                conv_bn(f"{block}.{branch}", branch_leaves)
    return state


def _load_collection(collection: MetricCollection, state: Dict[str, Any]) -> MetricCollection:
    grouped = {name for group in collection.compute_groups.values() for name in group[1:]}
    for name, metric in collection.items(keep_base=True, copy_state=False):
        if name in grouped:
            continue
        prefix = f"{name}."
        load_jax_state(metric, {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
    collection._repoint()
    return collection
