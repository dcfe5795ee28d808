"""MetricTracker (counterpart of ``metrics_tpu/wrappers/tracker.py``): a metric or a
collection tracked over steps, with the best value and step. A plain class, as in the
JAX package; each step is a reset deep copy of the base, on its device."""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn


class MetricTracker:
    """List of metric copies over time steps."""

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a Metric or MetricCollection" f" but got {metric}"
            )
        self._base_metric = metric
        self._metrics: List[Union[Metric, MetricCollection]] = []
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of steps tracked so far."""
        return len(self._metrics)

    def increment(self) -> None:
        """Start a new step with a reset copy of the base metric."""
        self._increment_called = True
        metric = deepcopy(self._base_metric)
        metric.reset()
        self._metrics.append(metric)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """Every step's value, stacked along a first axis (a dict of them for a collection);
        the list of values where they do not stack (nested results)."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        try:
            if isinstance(self._base_metric, MetricCollection):
                keys = res[0].keys()
                return {k: torch.stack([torch.as_tensor(r[k]) for r in res], 0) for k in keys}
            return torch.stack([torch.as_tensor(r) for r in res], 0)
        except (TypeError, RuntimeError):  # a dict where a tensor should be: nested results
            return res

    def reset(self) -> None:
        """Reset the current step's metric."""
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[None, float, Tuple[float, int], Dict[str, Optional[float]], Tuple[Dict, Dict]]:
        """The best value (and its step) over the tracked steps; a NaN value is the best,
        as ``argmax``/``argmin`` take it in the JAX package."""
        res = self.compute_all()
        if isinstance(res, list):
            rank_zero_warn(
                "Encounted nested structure. You are probably using a metric collection inside a metric collection,"
                " or a metric wrapper inside a metric collection, which is not supported by `.best_metric()` method."
                " Returning `None` instead."
            )
            return (None, None) if return_step else None

        if isinstance(self._base_metric, Metric):
            fn = torch.argmax if self.maximize else torch.argmin
            try:
                idx = int(fn(res))
                value = res[idx]
                if return_step:
                    return float(value), idx
                return float(value)
            except (ValueError, TypeError, RuntimeError, IndexError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    " this is probably due to the 'best' not being defined for this metric."
                    " Returning `None` instead.",
                    UserWarning,
                )
                return (None, None) if return_step else None

        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value, idx = {}, {}
        for i, (k, v) in enumerate(res.items()):
            try:
                fn = torch.argmax if maximize[i] else torch.argmin
                out = int(fn(v))
                value[k], idx[k] = float(v[out]), out
            except (ValueError, TypeError, RuntimeError, IndexError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f" {error} this is probably due to the 'best' not being defined for this metric."
                    " Returning `None` instead.",
                    UserWarning,
                )
                value[k], idx[k] = None, None

        if return_step:
            return value, idx
        return value

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")
