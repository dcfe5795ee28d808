"""BootStrapper (counterpart of ``metrics_tpu/wrappers/bootstrapping.py``).

``num_bootstraps`` resamples of each batch, with replacement along dim 0, each
feeding its own copy of the base metric; ``compute`` gives the copies' ``mean``,
``std``, ``quantile`` and ``raw`` values. Two paths, as in the JAX package:

- **Stacked** (a base with fixed-shape tensor states, no host-side update and no
  child metrics, :meth:`BootStrapper._stackable`): one template copy and registered
  ``boot_<name>`` states of shape ``(num_bootstraps, *state)``, with the base's
  reductions and persistence. Each ``update`` is one step: the resample indices of
  every copy, then the base's ``local_update`` of every copy under
  ``torch.func.vmap``, run through ``core.fleet.run_step``: on the card one replay of
  a CUDA graph per input signature, in which a confusion-count histogram is one
  launch of the histogram kernel's batched mode. ``compute`` is the base's
  ``compute_from`` under ``vmap``. With ``fleet_size`` the states are ``(fleet,
  num_bootstraps, *state)`` and ``compute`` gives each stream's values.
- **Copies** (other bases): ``num_bootstraps`` copies in an ``nn.ModuleList``, each
  updated with its resample. The indices come from ``np.random.default_rng(seed)``
  in the JAX copies path's order (per update, per copy, one
  :func:`_bootstrap_sampler` call), so they are the JAX package's, bit for bit.

The stacked path's draws. Per ``update`` the wrapper takes one seed from its host
``np.random.default_rng(seed)`` stream, where the JAX package's stacked path takes
its ``jax.random`` key seed, and seeds a ``torch.Generator`` on the metric's device
with it. The draws (``(N, size)`` float32 uniforms and int64 pad indices for
``"poisson"``, the int64 indices themselves for ``"multinomial"``) are made before
the step and are inputs of its replay, so no RNG runs inside a CUDA graph. Inside
the step :func:`_indices_from_draws` turns them into indices exactly as the JAX
package's ``_device_sample`` (:261-270) turns its draws: the same inverse-CDF
Poisson(1) counts, the same truncation and padding. Deviation: the draws come from
torch's Philox generator, not ``jax.random``, whose bits torch cannot reproduce.

The pure tier (``init_state``/``local_update``/``sync_state``/``compute_from``, JAX
:228-326) carries a host int64 seed tensor in its state in place of the JAX key;
each ``local_update`` derives its draws' seed from it by a SplitMix64 step, so a
seeded state replays identically. A ``CatBuffer`` base (``cat_capacity``) works
there: every copy appends exactly ``size`` rows, so one host count and one overflow
flag serve the ``(N, capacity, ...)`` stack, and ``compute_from`` of exact-curve
copies is one batched sort and one scan launch.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch import _build
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.wrappers import _stack
from metrics_tpu_torch.wrappers._device import base_device_kwargs

#: float32 bits of the Poisson(1) CDF at k = 0..16, ``cumsum(exp(-1 - gammaln(k + 1)))``
#: as the JAX package's float32 XLA program computes it (``_device_sample``); torch's
#: ``lgamma``/``exp`` round some entries differently, so the table is kept as bits
_POISSON_CDF_BITS = (
    0x3EBC5AAC, 0x3F3C5AAF, 0x3F6B715B, 0x3F7B2394, 0x3F7F1022, 0x3F7FD90B, 0x3F7FFA87, 0x3F7FFF50, 0x3F7FFFE9,
    0x3F7FFFFA, 0x3F7FFFFC, 0x3F7FFFFC, 0x3F7FFFFC, 0x3F7FFFFC, 0x3F7FFFFC, 0x3F7FFFFC, 0x3F7FFFFC,
)
_SEED_BOUND = 2**63 - 1
_MASK64 = (1 << 64) - 1


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


_POISSON_CDF: Dict[str, Tensor] = {}


def poisson_cdf(device: Any = None) -> Tensor:
    """The 17-entry float32 Poisson(1) CDF of the JAX package's ``_device_sample``, one
    tensor per device: a captured step reads it and copies nothing from the host. A
    trace on fake tensors (analysis/san) leaves the cache as it was."""
    cdf = _POISSON_CDF.get(str(device))
    if cdf is None:
        bits = torch.tensor(_POISSON_CDF_BITS, dtype=torch.int64).to(torch.int32)
        cdf = bits.view(torch.float32).to(device)
        if not _build.faking(cdf):
            _POISSON_CDF[str(device)] = cdf
    return cdf


def _indices_from_draws(u: Tensor, pad: Tensor, size: int) -> Tensor:
    """Poisson(1) resample indices ``(..., size)`` from uniforms ``u`` and pad indices
    ``pad`` of that shape: JAX ``_device_sample`` (:261-270) given the same draws.

    Row ``i`` is repeated ``#{k : u_i > cdf_k}`` times, the repeats truncated to
    ``size``; positions past the repeats' total take ``pad``."""
    counts = (u.unsqueeze(-1) > poisson_cdf(u.device)).sum(-1)
    ends = torch.cumsum(counts, -1)
    pos = torch.arange(size, device=u.device).expand_as(ends).contiguous()
    # position j repeats the first row whose running count passes j
    idx = torch.searchsorted(ends, pos, right=True).clamp_max(max(size - 1, 0))
    return torch.where(pos < ends[..., -1:], idx, pad)


def _mix64(x: int) -> int:
    """One SplitMix64 step, kept below 2^63 (a torch generator seed and an int64)."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _SEED_BOUND


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
        self._eager_stacked = self._stackable(base_metric)
        if self._eager_stacked:
            self.metrics = nn.ModuleList([deepcopy(base_metric)])
            for name, default in base_metric._defaults.items():
                stacked = default.unsqueeze(0).repeat(num_bootstraps, *([1] * default.dim()))
                self.add_state(
                    f"boot_{name}",
                    stacked,
                    dist_reduce_fx=base_metric._reductions[name],
                    persistent=base_metric._persistent[name],
                )
        else:
            if self.fleet_size is not None:
                raise MetricsUserError(
                    "BootStrapper takes `fleet_size` for a base it stacks (fixed-shape tensor states);"
                    f" {type(base_metric).__name__} keeps its state in per-copy metrics, so there is"
                    " nothing to route. Make the base metric the fleet instead."
                )
            self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_bootstraps)])

    @staticmethod
    def _stackable(base: Metric) -> bool:
        """Can one stacked state stand for the copies? Fixed-shape tensor states, an
        update that runs on the device, and no child metrics (JAX :125-137)."""
        if getattr(type(base), "_host_side_update", False) or not base._defaults:
            return False
        if any(isinstance(v, (list, CatBuffer)) for v in base._defaults.values()):
            return False
        return not base._child_metrics()

    @staticmethod
    def _batch_size(args: Any, kwargs: Any) -> int:
        sizes: List[int] = []
        apply_to_collection((args, kwargs), Tensor, lambda x: sizes.append(len(x)))
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        return sizes[0]

    # ------------------------------------------------------------- the draws

    def _draw(self, size: int) -> List[np.ndarray]:
        """One update's indices of the copies path, a host array per copy, in the JAX
        copies path's order."""
        return [_bootstrap_sampler(size, self.sampling_strategy, self._rng) for _ in range(self.num_bootstraps)]

    def _device_draws(self, seed: int, size: int) -> Tuple[Tensor, ...]:
        """The ``(N, size)`` draws of one update from a generator on the metric's device
        seeded with ``seed``: ``(u, pad)`` for ``"poisson"``, ``(indices,)`` for
        ``"multinomial"``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        shape, device = (self.num_bootstraps, size), self.device
        if self.sampling_strategy == "multinomial":
            return (torch.randint(0, max(size, 1), shape, generator=g, device=device),)
        u = torch.rand(shape, generator=g, device=device)
        return u, torch.randint(0, max(size, 1), shape, generator=g, device=device)

    def _update_draws(self, size: int) -> Tuple[Tensor, ...]:
        """The draws of an eager stacked update, seeded from the host seed stream. Under
        a fleet's ``vmap`` over streams or routed rows (``randomness="same"``) they are
        drawn once, for all of them alike."""
        return self._device_draws(int(self._rng.integers(0, _SEED_BOUND)), size)

    def _indices(self, draws: Sequence[Tensor], size: int) -> Tensor:
        """``(N, size)`` resample indices from the draws (or the indices themselves)."""
        if len(draws) == 2:
            return _indices_from_draws(draws[0], draws[1], size)
        return draws[0]

    # ------------------------------------------------------- the stacked step

    def _resampled_update(self, state: Dict[str, Any], indices: Tensor, args: Tuple, kwargs: Dict) -> Dict[str, Any]:
        """Pure: the base's ``local_update`` of every copy with its resample of the
        inputs along dim 0, in one ``vmap`` over the copies."""
        from metrics_tpu_torch.core import fused as _fused

        dyn, spec = _fused._split_inputs(args, kwargs)
        gathered = [x[indices] for x in dyn]  # (N, size, ...) rows of each tensor input
        return _stack.vmap_local_update(self.metrics[0], state, lambda g: _fused._merge_inputs(g, spec), gathered)

    def _stacked_update(self, draws: Sequence[Tensor], args: Tuple, kwargs: Dict) -> None:
        from metrics_tpu_torch.core import fleet as _fleet
        from metrics_tpu_torch.core import fused as _fused

        base = self.metrics[0]
        size = self._batch_size(args, kwargs)
        state = {name: getattr(self, f"boot_{name}") for name in base._defaults}
        poisson_cdf(draws[0].device)  # made here, never inside a capture
        dyn, spec = _fused._split_inputs(args, kwargs)

        def step(st: Dict[str, Tensor], dr: List[Tensor], dl: List[Tensor]) -> Dict[str, Tensor]:
            a, kw = _fused._merge_inputs(dl, spec)
            return self._resampled_update(st, self._indices(dr, size), a, kw)

        new = _fleet.run_step(
            self, f"boot.update.{len(draws)}", step, state, list(draws), dyn, static_key=_fused._static_key(spec)
        )
        for name, value in new.items():
            setattr(self, f"boot_{name}", value)

    def _stacked_update_with_indices(self, indices: Tensor, *args: Any, **kwargs: Any) -> None:
        """A stacked update with given ``(N, size)`` resample indices in place of the
        draws: the seam through which the tests feed the JAX package's indices.
        Counts like ``update``."""
        args = tuple(self._check_device(a) for a in args)
        kwargs = {k: self._check_device(v) for k, v in kwargs.items()}
        self._computed = None
        self._update_count += 1
        self._stacked_update((self._check_device(indices).to(torch.int64),), args, kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each copy with its resample of the batch along dim 0."""
        if self._eager_stacked:
            self._stacked_update(self._update_draws(self._batch_size(args, kwargs)), args, kwargs)
            return
        draws = self._draw(self._batch_size(args, kwargs))
        indices = torch.from_numpy(np.concatenate(draws).astype(np.int64)).to(self.device)  # one transfer
        for metric, idx in zip(self.metrics, torch.split(indices, [len(d) for d in draws])):
            take = lambda x: x.index_select(0, idx)  # noqa: E731
            metric.update(*apply_to_collection(args, Tensor, take), **apply_to_collection(kwargs, Tensor, take))

    def _summary(self, computed_vals: Tensor) -> Dict[str, Tensor]:
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

    def compute(self) -> Dict[str, Tensor]:
        """mean / std / quantile / raw over the copies' values."""
        if self._eager_stacked:
            base = self.metrics[0]
            computed_vals = _stack.vmap_compute(base, {name: getattr(self, f"boot_{name}") for name in base._defaults})
        else:
            computed_vals = torch.stack([torch.as_tensor(m.compute(), device=self.device) for m in self.metrics], 0)
        return self._summary(computed_vals)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    # --------------------------------------------------- pure-functional tier

    def init_state(self) -> Dict[str, Any]:
        """One stacked ``(num_bootstraps, ...)`` base state and a host int64 seed."""
        base = self.metrics[0].init_state()
        _stack.check_static("BootStrapper", base)
        # seed=None draws fresh entropy per init_state, as the eager tier's default_rng()
        seed = self._seed if self._seed is not None else int(self._rng.integers(0, _SEED_BOUND))
        return {"seed": torch.tensor(seed, dtype=torch.int64), "metrics": _stack.stack_state(base, self.num_bootstraps)}

    def local_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every copy in one ``vmap``, resampled with draws on the device; the seed
        advances by one SplitMix64 step."""
        seed = _mix64(int(state["seed"]))
        draws = self._device_draws(seed, self._batch_size(args, kwargs))
        return {"seed": torch.tensor(seed, dtype=torch.int64), "metrics": self._pure_update(state, draws, args, kwargs)}

    def _pure_update(self, state: Dict[str, Any], draws: Sequence[Tensor], args: Tuple, kwargs: Dict) -> Dict[str, Any]:
        args = tuple(self._check_device(a) for a in args)
        kwargs = {k: self._check_device(v) for k, v in kwargs.items()}
        return self._resampled_update(state["metrics"], self._indices(draws, self._batch_size(args, kwargs)), args, kwargs)

    def _local_update_with_indices(self, state: Dict[str, Any], indices: Tensor, *args: Any, **kwargs: Any):
        """``local_update`` with given ``(N, size)`` indices in place of the draws (the
        seed does not advance): the seam through which the tests feed known indices."""
        indices = self._check_device(indices).to(torch.int64)
        return {"seed": state["seed"], "metrics": self._pure_update(state, (indices,), args, kwargs)}

    def sync_state(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """Per-copy sync: the base reductions apply elementwise over the stack; every
        rank leaves with the same seed (the largest)."""
        base = self.metrics[0]
        if any(kind == "cat" for kind in base._reductions.values()):
            raise NotImplementedError(
                "BootStrapper's pure tier cannot sync cat-reduction base states over a"
                " mesh axis; evaluate per shard and combine computes instead"
            )
        seed = state["seed"]
        if group is not None:
            from metrics_tpu_torch.parallel import collective

            seed = collective.sync_array(seed.to(self.device), "max", group).cpu()
        return {"seed": seed, "metrics": base.sync_state(state["metrics"], group)}

    def compute_from(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Tensor]:
        if group is not None:
            state = self.sync_state(state, group)
        return self._summary(_stack.vmap_compute(self.metrics[0], state["metrics"]))

    # ------------------------------------------------------------ conversion

    def _jax_child_states(self, state: Dict[str, Any]) -> Optional[List[Tuple[Metric, Dict[str, Any]]]]:
        """A JAX stacked state dict (``boot_<name>`` entries, ``(num_bootstraps, *state)``):
        the stacked path loads it as its own states (None: no children to load); the
        copies path gives copy ``k`` row ``k``."""
        if "key" in state and "metrics" in state:
            raise ValueError(
                "load_jax_state: this is a BootStrapper pure-tier state, whose `key` is a jax.random key"
                " that the port cannot use (its draws come from torch generators); load the metrics'"
                " stacked states into `init_state()['metrics']` instead, or an eager `state_dict()`"
            )
        stacked = {k[len("boot_"):]: np.asarray(v) for k, v in state.items() if k.startswith("boot_")}
        if not stacked:
            raise KeyError(
                "load_jax_state: a BootStrapper loads the JAX package's stacked state (`boot_<name>` entries);"
                f" got {sorted(state)}"
            )
        axis = 0 if self.fleet_size is None else 1
        if any(v.ndim <= axis or v.shape[axis] != self.num_bootstraps for v in stacked.values()):
            raise ValueError(
                f"load_jax_state: stacked bootstrap states {[v.shape for v in stacked.values()]} do not have"
                f" {self.num_bootstraps} rows"
            )
        if self._eager_stacked:
            return None
        return [(m, {name: v[k] for name, v in stacked.items()}) for k, m in enumerate(self.metrics)]
