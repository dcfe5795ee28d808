"""BootStrapper (counterpart of ``metrics_tpu/wrappers/bootstrapping.py``).

``num_bootstraps`` copies of the base metric, registered as an ``nn.ModuleList``;
each ``update`` resamples the batch along dim 0 with replacement for each copy. The
indices come from ``np.random.default_rng(seed)`` in the order of the JAX package's
copies path: per update, per copy, one :func:`_bootstrap_sampler` call. So where the
JAX package takes that path (a base with list states, or one with child metrics),
the resamples are the same, bit for bit. An update's indices go to the device in
one transfer and each copy gathers its rows there with ``index_select``.

Deviation: the JAX package keeps a base with fixed-shape states as one stacked
``(num_bootstraps, ...)`` state updated by one vmapped launch, with indices drawn by
``jax.random``, which torch cannot reproduce. The port takes the copies path for every
base; :func:`~metrics_tpu_torch.convert.load_jax_state` splits such a stacked state
(``boot_<name>``) into the copies. ``fleet_size`` and the pure tier are not ported.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.wrappers._device import base_device_kwargs


def _bootstrap_sampler(
    size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Resample indices ``[0, size)`` with replacement, on the host (the JAX package's
    draws, in the same order)."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size=size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(Metric):
    """Bootstrapped confidence intervals of any metric: ``compute`` gives the copies'
    ``mean``, ``std`` (``correction=1``), ``quantile`` (linear) and ``raw`` values."""

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float], Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(**base_device_kwargs("BootStrapper", base_metric, kwargs))
        self._seed = seed
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self._rng = np.random.default_rng(seed)
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but recieved {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_bootstraps)])

    @staticmethod
    def _batch_size(args: Any, kwargs: Any) -> int:
        sizes: List[int] = []
        apply_to_collection((args, kwargs), Tensor, lambda x: sizes.append(len(x)))
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        return sizes[0]

    def _draw(self, size: int) -> List[np.ndarray]:
        """One update's indices, a host array per copy, in the JAX copies path's order."""
        return [_bootstrap_sampler(size, self.sampling_strategy, self._rng) for _ in range(self.num_bootstraps)]

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each copy with its resample of the batch along dim 0."""
        draws = self._draw(self._batch_size(args, kwargs))
        indices = torch.from_numpy(np.concatenate(draws).astype(np.int64)).to(self.device)  # one transfer
        for metric, idx in zip(self.metrics, torch.split(indices, [len(d) for d in draws])):
            take = lambda x: x.index_select(0, idx)  # noqa: E731
            metric.update(*apply_to_collection(args, Tensor, take), **apply_to_collection(kwargs, Tensor, take))

    def compute(self) -> Dict[str, Tensor]:
        """mean / std / quantile / raw over the copies' values."""
        computed_vals = torch.stack([torch.as_tensor(m.compute(), device=self.device) for m in self.metrics], 0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(0)
        if self.std:
            output_dict["std"] = computed_vals.std(0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    def _jax_child_states(self, state: Dict[str, Any]) -> List[Tuple[Metric, Dict[str, Any]]]:
        """Each copy with its part of a JAX stacked ``BootStrapper``'s state dict, whose
        ``boot_<name>`` entries are ``(num_bootstraps, *state)``: copy ``k`` takes row ``k``."""
        stacked = {k[len("boot_"):]: np.asarray(v) for k, v in state.items() if k.startswith("boot_")}
        if not stacked:
            raise KeyError(
                "load_jax_state: a BootStrapper loads the JAX package's stacked state (`boot_<name>` entries);"
                f" got {sorted(state)}"
            )
        if any(v.shape[0] != self.num_bootstraps for v in stacked.values()):
            raise ValueError(
                f"load_jax_state: stacked bootstrap states {[v.shape for v in stacked.values()]} do not have"
                f" {self.num_bootstraps} rows"
            )
        return [(m, {name: v[k] for name, v in stacked.items()}) for k, m in enumerate(self.metrics)]
