"""MultioutputWrapper (counterpart of ``metrics_tpu/wrappers/multioutput.py``): one copy
of a base metric per output, registered as an ``nn.ModuleList``, each fed its slice of
the inputs along ``output_dim``. With ``remove_nans`` the rows where any input of an
output holds a NaN are dropped; the mask is built on the inputs' device (the JAX
package goes through numpy)."""
from copy import deepcopy
from typing import Any, List, Optional, Tuple

import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.wrappers._device import base_device_kwargs


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows where any tensor has a NaN, as a bool mask on their device."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    sentinel = tensors[0]
    nan_idxs = torch.zeros(len(sentinel), dtype=torch.bool, device=sentinel.device)
    for tensor in tensors:
        nan_idxs |= torch.isnan(tensor.reshape(len(sentinel), -1)).any(1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """Evaluate one metric per output dimension."""

    is_differentiable = False
    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**base_device_kwargs("MultioutputWrapper", base_metric, kwargs))
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_outputs)])
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[tuple, dict]]:
        """Each output's slice of the inputs (a view), its NaN rows dropped with ``remove_nans``."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            def select(x: Tensor, i: int = i) -> Tensor:
                if self.squeeze_outputs:
                    return x.select(self.output_dim, i)
                return x.narrow(self.output_dim, i, 1)

            selected_args = apply_to_collection(args, Tensor, select)
            selected_kwargs = apply_to_collection(kwargs, Tensor, select)
            if self.remove_nans:
                tensors = [a for a in selected_args if isinstance(a, Tensor)] + [
                    v for v in selected_kwargs.values() if isinstance(v, Tensor)
                ]
                if tensors:
                    keep = ~_get_nan_indices(*tensors)
                    selected_args = tuple(a[keep] if isinstance(a, Tensor) else a for a in selected_args)
                    selected_kwargs = {k: v[keep] if isinstance(v, Tensor) else v for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> Tensor:
        return torch.stack([torch.as_tensor(m.compute(), device=self.device) for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._update_count += 1
        self._computed = None  # the JAX package keeps its cached value: a stale compute after forward
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return torch.stack([torch.as_tensor(r, device=self.device) for r in results], 0)

    def reset(self) -> None:
        for metric in self.metrics:
            metric.reset()
        super().reset()
