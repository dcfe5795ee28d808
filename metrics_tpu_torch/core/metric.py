"""Core metric runtime: ``Metric`` as a ``torch.nn.Module``.

Counterpart of ``metrics_tpu/core/metric.py`` (``add_state`` :260, ``merge_state``
:402, ``update``/``compute`` :534/538, ``forward`` :707, ``reset`` :967), with the
same state contract:

- ``add_state`` registers a tensor state (reduced by ``"sum"``, ``"mean"``,
  ``"max"``, ``"min"``, ``None`` or a callable) as a buffer, or an empty list for a
  ``"cat"`` state, kept as a plain Python list of tensors.
- ``update`` accumulates in place of the live states, ``compute`` caches its value
  until the next ``update``, ``forward`` accumulates and returns the batch value
  (full-state or reduce-state strategy), ``reset`` restores the defaults.
- ``state_dict`` holds the persistent states only (none by default), as the JAX
  package does; list states go in as lists of tensors.

Device: states live on ``device`` (``cuda`` unless the caller names another, and
constructing on ``cuda`` without a card raises). An update input on another device
raises; array-likes that are not tensors are copied to the metric's device.

Not in this slice: the fleet axis, the fused engine, observability, fault injection,
checkpointing and the cross-process sync of the JAX package.
"""
import functools
from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.utils.data import (
    _resolve_device,
    _same_device,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    to_tensor,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError, MetricsUserWarning
from metrics_tpu_torch.utils.prints import rank_zero_warn

_REDUCE_KIND_TO_FN = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}
_CONST_ATTRS = (
    "higher_is_better",
    "is_differentiable",
    "full_state_update",
    "plot_lower_bound",
    "plot_upper_bound",
    "plot_legend_name",
)


def _squeeze_if_scalar(value: Any) -> Any:
    if isinstance(value, Tensor) and value.numel() == 1:
        return value.reshape(())
    if isinstance(value, (list, tuple)):
        return type(value)(_squeeze_if_scalar(v) for v in value)
    if isinstance(value, dict):
        return {k: _squeeze_if_scalar(v) for k, v in value.items()}
    return value


class Metric(nn.Module, ABC):
    """Base class for all metrics.

    Subclasses implement ``update(self, ...)``, which changes the registered states,
    and ``compute(self)``.

    Args (keyword-only):
        device: where the states live and updates run; ``cuda`` by default.
        compute_on_cpu: move list states to the CPU after each update.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._device = _resolve_device(kwargs.pop("device", None))

        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._defaults: Dict[str, Union[Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Any] = {}

        self._update_count = 0
        self._computed: Any = None
        self._forward_cache: Any = None

        self.update: Callable = self._wrap_update(self.update)
        self.compute: Callable = self._wrap_compute(self.compute)

    # ------------------------------------------------------------------ state

    def add_state(
        self,
        name: str,
        default: Union[Tensor, list, float, int],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
    ) -> None:
        """Register a state: a tensor (reset value) or an empty list (a ``cat`` state).

        ``dist_reduce_fx`` is one of ``"sum" | "mean" | "max" | "min" | "cat" | None`` or
        a callable applied to a stacked ``(k, ...)`` tensor; ``forward`` and
        ``merge_state`` combine states with it.
        """
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        is_list = isinstance(default, list)
        if is_list and default:
            raise ValueError("Unexpected type of `default` value: list states must start empty")
        if dist_reduce_fx is not None and not (dist_reduce_fx in _REDUCE_KIND_TO_FN or callable(dist_reduce_fx)):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if is_list:
            setattr(self, name, [])
            self._defaults[name] = []
        else:
            default = torch.as_tensor(default).to(self._device)
            self.register_buffer(name, default.clone(), persistent=False)
            self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx

    @property
    def metric_state(self) -> Dict[str, Union[Tensor, List[Tensor]]]:
        """Current state values by name."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    @property
    def device(self) -> torch.device:
        """Device of the metric states."""
        return self._device

    def merge_state(self, other: Union["Metric", Dict[str, Any]]) -> None:
        """Merge another instance's state (or a state dict) into the live state, in place.

        Only reductions with a pairwise merge are accepted: ``sum``/``max``/``min``
        tensor states and ``cat`` list states; others raise :class:`MetricsUserError`.
        """
        if isinstance(other, Metric):
            if set(other._defaults) != set(self._defaults):
                raise MetricsUserError(
                    f"Cannot merge state of {type(other).__name__} into {type(self).__name__}:"
                    f" state registries differ ({sorted(other._defaults)} vs {sorted(self._defaults)})"
                )
            incoming = {name: getattr(other, name) for name in other._defaults}
            incoming_count = other._update_count
        else:
            incoming = other
            incoming_count = 0

        merged: Dict[str, Any] = {}
        for name, reduce_kind in self._reductions.items():
            if name not in incoming:
                raise MetricsUserError(f"merge_state: incoming state is missing `{name}`")
            mine, theirs = getattr(self, name), incoming[name]
            if reduce_kind == "cat" and isinstance(mine, list):
                merged[name] = list(mine) + [self._check_device(t) for t in theirs]
            elif reduce_kind == "sum":
                merged[name] = mine + self._check_device(theirs)
            elif reduce_kind == "max":
                merged[name] = torch.maximum(mine, self._check_device(theirs))
            elif reduce_kind == "min":
                merged[name] = torch.minimum(mine, self._check_device(theirs))
            else:
                raise MetricsUserError(
                    f"merge_state: state `{name}` has reduction {reduce_kind!r}, which has no"
                    " well-defined pairwise merge (supported: sum, max, min, cat lists)"
                )
        for name, value in merged.items():
            setattr(self, name, value)
        self._update_count += incoming_count
        self._computed = None

    # ------------------------------------------------------------- OO shell

    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate statistics into the registered states."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the final value from the accumulated states."""

    def _check_device(self, value: Any) -> Any:
        """``value`` as a tensor on the metric's device; a tensor elsewhere raises."""
        if isinstance(value, Tensor):
            if not _same_device(value.device, self._device):
                raise RuntimeError(
                    f"{type(self).__name__}: input tensor is on {value.device}, but the metric's"
                    f" states are on {self._device}; move the input (or the metric) explicitly."
                )
            return value
        if isinstance(value, (np.ndarray, np.generic, list, tuple)):
            return to_tensor(value, self._device)
        return value

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            args = tuple(self._check_device(a) for a in args)
            kwargs = {k: self._check_device(v) for k, v in kwargs.items()}
            self._computed = None
            self._update_count += 1
            update(*args, **kwargs)
            if self.compute_on_cpu:
                self._move_list_states_to_cpu()

        return wrapped_func

    def _move_list_states_to_cpu(self) -> None:
        for key in self._defaults:
            current_val = getattr(self, key)
            if isinstance(current_val, list):
                setattr(self, key, [v.to("cpu") for v in current_val])

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    MetricsUserWarning,
                )
            if self._computed is not None:
                return self._computed
            self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            return self._computed

        return wrapped_func

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the global state and return the metric's value on this batch alone.

        ``full_state_update`` picks the strategy: True (or None) runs ``update`` twice,
        once on the global state and once on a fresh one; False runs it once on a
        fresh state and merges that into the global state.
        """
        if self.full_state_update or self.full_state_update is None:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        update_count = self._update_count
        compute_on_cpu = self.compute_on_cpu
        self.compute_on_cpu = False
        cache = {attr: getattr(self, attr) for attr in self._defaults}

        self.reset()
        self.update(*args, **kwargs)
        batch_val = self.compute()

        for attr, val in cache.items():
            setattr(self, attr, val)
        self._update_count = update_count
        self._computed = None
        self.compute_on_cpu = compute_on_cpu
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = {attr: getattr(self, attr) for attr in self._defaults}
        update_count = self._update_count
        self.reset()
        compute_on_cpu = self.compute_on_cpu
        self.compute_on_cpu = False

        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._update_count = update_count + 1
        self._reduce_states(global_state)
        self._computed = None
        self.compute_on_cpu = compute_on_cpu
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return batch_val

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Merge the global state held before ``forward`` with the batch's state."""
        for attr in self._defaults:
            local_state = getattr(self, attr)
            global_state = incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if reduce_fn == "sum":
                reduced = global_state + local_state
            elif reduce_fn == "mean":
                reduced = ((self._update_count - 1) * global_state + local_state) / self._update_count
            elif reduce_fn == "max":
                reduced = torch.maximum(global_state, local_state)
            elif reduce_fn == "min":
                reduced = torch.minimum(global_state, local_state)
            elif reduce_fn == "cat" or (reduce_fn is None and isinstance(global_state, list)):
                reduced = list(global_state) + list(local_state)
            elif reduce_fn is None:
                reduced = torch.stack([global_state, local_state])
            elif callable(reduce_fn):
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            else:
                raise TypeError(f"Unsupported reduce_fn: {reduce_fn}")
            setattr(self, attr, reduced)

    def reset(self) -> None:
        """Restore the default states."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr, default in self._defaults.items():
            setattr(self, attr, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    # ------------------------------------------------------------ persistence

    def persistent(self, mode: bool = False) -> None:
        """Set whether every state goes into ``state_dict``."""
        for key in self._persistent:
            self._persistent[key] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        # every buffer is registered non-persistent; the metric's own flags decide
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            value = getattr(self, key)
            if isinstance(value, list):
                destination[prefix + key] = [v if keep_vars else v.detach().clone() for v in value]
            else:
                destination[prefix + key] = value if keep_vars else value.detach().clone()

    def _load_from_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str,
        local_metadata: Dict[str, Any],
        strict: bool,
        missing_keys: List[str],
        unexpected_keys: List[str],
        error_msgs: List[str],
    ) -> None:
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                value = state_dict.pop(name)
                if isinstance(value, list):
                    setattr(self, key, [torch.as_tensor(v).to(self._device) for v in value])
                else:
                    setattr(self, key, torch.as_tensor(value).to(self._device, self._defaults[key].dtype))
        self._computed = None
        super()._load_from_state_dict(
            state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
        )

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        """Move defaults and list states with the buffers (``.to``, ``.cuda``, ``.cpu``)."""
        super()._apply(fn, *args, **kwargs)
        self._defaults = {k: (v if isinstance(v, list) else fn(v)) for k, v in self._defaults.items()}
        for key, default in self._defaults.items():
            if isinstance(default, list):
                setattr(self, key, [fn(v) for v in getattr(self, key)])
        for default in self._defaults.values():
            if isinstance(default, Tensor):
                self._device = default.device
                break
        self._computed = None
        return self

    def type(self, dst_type: Any) -> "Metric":  # noqa: A003 - parity with the JAX package
        """No-op: a metric's state dtypes change only through its own code."""
        return self

    def float(self) -> "Metric":  # noqa: A003
        return self

    def double(self) -> "Metric":  # noqa: A003
        return self

    def half(self) -> "Metric":  # noqa: A003
        return self

    # ----------------------------------------------------------- call / misc

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state.pop("update", None)
        state.pop("compute", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self.update = self._wrap_update(type(self).update.__get__(self))
        self.compute = self._wrap_compute(type(self).compute.__get__(self))

    def __setattr__(self, name: str, value: Any) -> None:
        if name in _CONST_ATTRS:
            raise RuntimeError(f"Can't change const `{name}`.")
        super().__setattr__(name, value)

    def extra_repr(self) -> str:
        return f"device={self._device}"
