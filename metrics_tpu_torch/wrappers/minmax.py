"""MinMaxMetric (counterpart of ``metrics_tpu/wrappers/minmax.py``): the base metric's
value with the smallest and largest values its computes have given. With
``fleet_size`` the running min and max have a stream axis, as in the JAX package; the
streams share the one base metric, so an update takes no ``stream_ids``, its step runs
eagerly (it updates the base, outside the wrapper's own state), and one compute of the
base moves every stream's min and max."""
from typing import Any, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.wrappers._device import base_device_kwargs


class MinMaxMetric(Metric):
    """Track a base metric's value and its running min and max over ``compute`` calls."""

    full_state_update: Optional[bool] = True
    # a fleet's streams share the base metric: a routed update has nowhere to send its rows
    _fleet_routes_rows: bool = False

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        super().__init__(**base_device_kwargs("MinMaxMetric", base_metric, kwargs))
        self._base_metric = base_metric
        self.add_state("min_val", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        as_f32 = torch.as_tensor(val, dtype=torch.float32, device=self.device).reshape(())
        self.max_val = torch.where(self.max_val < as_f32, as_f32, self.max_val)
        self.min_val = torch.where(self.min_val > as_f32, as_f32, self.min_val)
        if self.fleet_size is not None:
            val = torch.as_tensor(val, device=self.device).reshape(()).expand(self.fleet_size)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def _compute_raw(self) -> Any:
        # a fleet's streams share the base: one compute updates every stream's running min
        # and max (the fleet's per-stream compute would drop them with its row states)
        return type(self).compute(self)

    def reset(self) -> None:
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        return False
