"""Aggregation metrics: max, min, sum, concatenation and mean of a stream of values
(counterpart of ``metrics_tpu/core/aggregation.py``).

``nan_strategy`` is ``"error"`` (raise on a NaN), ``"warn"`` (warn and drop the
NaNs), ``"ignore"`` (drop them) or a float that takes their place. PyTorch runs
On concrete inputs NaNs are removed as the JAX package removes them (finding one
reads a flag from the device); inside a traced step (a captured CUDA graph, the
fleet's ``vmap``, :func:`~metrics_tpu_torch.utils.checks.tracing`) they are replaced
by the reduction's identity instead, as under ``jit``.
"""
from typing import Any, Callable, List, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class BaseAggregator(Metric):
    """Base class of the aggregators: one ``value`` state reduced by ``fn``."""

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy}"
                f" but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn, cat_dtype=torch.float32)

    def _cast_and_nan_check_input(self, x: Union[float, Tensor], nan_identity: float = 0.0) -> Tensor:
        """``x`` as a float tensor on the metric's device (the ``value`` state's float
        dtype, else float32), with the NaN strategy applied; in a traced step NaNs
        become ``nan_identity``."""
        state = getattr(self, "value", None)
        dtype = state.dtype if isinstance(state, Tensor) and state.is_floating_point() else torch.float32
        x = self._check_device(x) if isinstance(x, Tensor) else torch.as_tensor(x, device=self._device)
        x = x.to(dtype)
        if self.nan_strategy in ("error", "warn", "ignore"):
            nans = torch.isnan(x)
            if not _is_concrete(x):
                x = torch.where(nans, torch.full((), nan_identity, dtype=dtype, device=x.device), x)
            elif bool(nans.any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encounted `nan` values in tensor")
                if self.nan_strategy == "warn":
                    rank_zero_warn("Encounted `nan` values in tensor. Will be removed.", UserWarning)
                x = x[~nans]
        else:  # float imputation
            x = torch.where(torch.isnan(x), torch.full((), self.nan_strategy, dtype=dtype, device=x.device), x)
        return x

    def update(self, value: Union[float, Tensor]) -> None:
        pass

    def compute(self) -> Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum."""

    full_state_update: bool = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value, nan_identity=-float("inf"))
        if value.numel():
            self.value = torch.maximum(self.value, value.max())


class MinMetric(BaseAggregator):
    """Running minimum."""

    full_state_update: bool = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value, nan_identity=float("inf"))
        if value.numel():
            self.value = torch.minimum(self.value, value.min())


class SumMetric(BaseAggregator):
    """Running sum."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = self.value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenation of every value."""

    full_state_update: bool = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, Tensor]) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> Tensor:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


def _broadcast_to(x: Tensor, shape: torch.Size) -> Tensor:
    """``torch.broadcast_to`` that raises ``ValueError``, as ``jnp.broadcast_to`` does: a
    weighted update whose NaN values were dropped, but not their weights, lands here."""
    lead = len(shape) - x.ndim
    if lead < 0 or any(d not in (1, n) for d, n in zip(x.shape, shape[lead:])):
        raise ValueError(f"Incompatible shapes for broadcasting: {tuple(x.shape)} and requested shape {tuple(shape)}")
    return torch.broadcast_to(x, shape)


class MeanMetric(BaseAggregator):
    """Weighted running mean: ``sum(value * weight) / sum(weight)``."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> None:
        value = self._cast_and_nan_check_input(value)
        weight = self._cast_and_nan_check_input(weight)
        if value.numel() == 0:
            return
        weight = _broadcast_to(weight, value.shape)
        self.value = self.value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> Tensor:
        return self.value / self.weight
