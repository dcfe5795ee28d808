"""ClasswiseWrapper (counterpart of ``metrics_tpu/wrappers/classwise.py``): a per-class
output tensor as a ``{name_label: value}`` dict. It lives on its metric's device. For a
fleet inner metric (``fleet_size``) the value is ``(fleet_size, num_classes)`` and each
dict value is a class's column, keeping the per-stream leading axis (JAX :37-42)."""
from typing import Any, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.wrappers._device import base_device_kwargs


class ClasswiseWrapper(Metric):
    """Per-class dict output of a metric with ``average=None``."""

    full_state_update: Optional[bool] = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        super().__init__(**base_device_kwargs("ClasswiseWrapper", metric, {}))
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.metric = metric
        self.labels = labels

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.metric.fleet_size is not None:
            if self.labels is None:
                return {f"{name}_{i}": x[..., i] for i in range(x.shape[-1])}
            return {f"{name}_{lab}": x[..., i] for i, lab in enumerate(self.labels)}
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._update_count += 1
        self._computed = None  # the JAX package keeps its cached value: a stale compute after forward
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()
