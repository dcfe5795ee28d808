"""MultioutputWrapper (counterpart of ``metrics_tpu/wrappers/multioutput.py``): one copy
of a base metric per output, registered as an ``nn.ModuleList``, each fed its slice of
the inputs along ``output_dim``. With ``remove_nans`` the rows where any input of an
output holds a NaN are dropped; the mask is built on the inputs' device (the JAX
package goes through numpy), and under a trace it raises the JAX package's
``ValueError``.

The pure tier (``init_state``/``local_update``/``sync_state``/``compute_from``, JAX
:160-206) carries one stacked ``(num_outputs, ...)`` base state and runs the base's
``local_update`` of every output under one ``torch.func.vmap``. ``remove_nans`` has no
static shape and raises ``NotImplementedError`` there. ``fleet_size`` on the wrapper
raises :class:`MetricsUserError`, as in the JAX package.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.wrappers import _stack
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
        if self.fleet_size is not None:
            raise MetricsUserError(
                "MultioutputWrapper holds its state in per-output child metrics,"
                " so fleet_size on the wrapper registers nothing to route; make"
                " the underlying metric the fleet instead (base_metric with"
                " fleet_size=N, updated with stream_ids)"
            )
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
                    if not _is_concrete(*tensors):
                        raise ValueError(
                            "MultioutputWrapper(remove_nans=True) filters rows by NaN"
                            " content and cannot run under jit/shard_map; use"
                            " remove_nans=False or filter rows on host first."
                        )
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

    # --------------------------------------------------- pure-functional tier

    def init_state(self) -> Dict[str, Any]:
        """One stacked ``(num_outputs, ...)`` base state."""
        base = self.metrics[0].init_state()
        _stack.check_static("MultioutputWrapper", base)
        return _stack.stack_state(base, len(self.metrics))

    def local_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every output column in one ``vmap``: output ``i`` takes index ``i`` of each
        tensor input along ``output_dim`` (kept as an axis of one without
        ``squeeze_outputs``)."""
        if self.remove_nans:
            raise NotImplementedError(
                "remove_nans drops a data-dependent number of rows and cannot run under"
                " jit; construct MultioutputWrapper(remove_nans=False) for the pure tier"
            )
        from metrics_tpu_torch.core import fused as _fused

        args = tuple(self._check_device(a) for a in args)
        kwargs = {k: self._check_device(v) for k, v in kwargs.items()}
        dyn, spec = _fused._split_inputs(args, kwargs)
        columns = [x.movedim(self.output_dim, 0) for x in dyn]  # (num_outputs, ...) each

        def one_inputs(cols: List[Tensor]) -> Tuple[Tuple, Dict]:
            if not self.squeeze_outputs:
                cols = [c.unsqueeze(self.output_dim) for c in cols]
            return _fused._merge_inputs(cols, spec)

        return _stack.vmap_local_update(self.metrics[0], state, one_inputs, columns)

    def sync_state(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """Per-output sync: the base reductions apply elementwise over the stack."""
        base = self.metrics[0]
        if any(kind == "cat" for kind in base._reductions.values()):
            raise NotImplementedError(
                "MultioutputWrapper's pure tier cannot sync cat-reduction base states"
                " over a mesh axis; evaluate per shard and combine computes instead"
            )
        return base.sync_state(state, group)

    def compute_from(self, state: Dict[str, Any], group: Optional[Any] = None) -> Tensor:
        if group is not None:
            state = self.sync_state(state, group)
        return _stack.vmap_compute(self.metrics[0], state)
