"""Core metric runtime: ``Metric`` as a ``torch.nn.Module``.

Counterpart of ``metrics_tpu/core/metric.py`` (``add_state`` :260, ``merge_state``
:402, ``update``/``compute`` :534/538, ``forward`` :707, ``reset`` :967), with the
same state contract:

- ``add_state`` registers a tensor state (reduced by ``"sum"``, ``"mean"``,
  ``"max"``, ``"min"``, ``None`` or a callable) as a buffer, or an empty list for a
  ``"cat"`` state, kept as a plain Python list of tensors or, when the metric is
  built with ``cat_capacity=N``, as a fixed-capacity
  :class:`~metrics_tpu_torch.core.state.CatBuffer`.
- ``update`` accumulates in place of the live states, ``compute`` caches its value
  until the next ``update``, ``forward`` accumulates and returns the batch value
  (full-state or reduce-state strategy), ``reset`` restores the defaults.
- ``state_dict`` holds the persistent states only (none by default), as the JAX
  package does; list states go in as lists of tensors, ``CatBuffer`` states as
  ``{"data", "count", "overflow"}``.
- ``compute`` syncs across processes first (``sync`` :860, ``_sync_dist`` :814,
  ``unsync`` :893): every state is gathered with ``dist_sync_fn`` (default
  :func:`~metrics_tpu_torch.utils.distributed.gather_all_tensors`), stacked and
  reduced by its ``dist_reduce_fx``; ``cat`` lists are concatenated before the
  gather, a ``CatBuffer`` goes across as its valid rows, and ``unsync`` restores
  the live states. ``dist_sync_on_step`` syncs ``forward``'s batch value too.
- Operators on metrics build a :class:`CompositionalMetric` (:1247-1365).
- The pure tier (:330-540): ``init_state`` gives fresh state dicts,
  ``local_update(state, ...)`` runs ``update`` on a state dict and returns the new
  one without touching the live state, ``sync_state(state, group)`` reduces a state
  dict over a ``torch.distributed`` process group (:mod:`~metrics_tpu_torch.parallel.collective`;
  the group takes the place of the JAX mesh axis, ``None`` is the identity) and
  ``compute_from(state, group)`` computes from one, NaN-poisoning float outputs
  when a ``CatBuffer`` overflowed on any rank.
- The fleet axis (:mod:`~metrics_tpu_torch.core.fleet`): ``fleet_size=N`` gives
  every state a leading ``(N, ...)`` stream axis, ``update(..., stream_ids=ids)``
  routes each row to its stream in one step, ``compute(stream=i)``, ``as_fleet``
  and ``reduce_fleet``.

Device: states live on ``device`` (``cuda`` unless the caller names another, and
constructing on ``cuda`` without a card raises). An update input on another device
raises; array-likes that are not tensors are copied to the metric's device.

- ``nan_policy`` (``None``, ``"warn"``, ``"raise"``, ``"count"``): the update
  wrapper counts the input rows holding NaN/Inf (one reduction on the device and one
  host read, only when a policy is set; skipped inside a captured or transformed
  step) and warns, raises :class:`~metrics_tpu_torch.fault.PoisonedInputError`
  before any state or count changes, or only counts (``nonfinite_rows`` in the
  registry of :mod:`~metrics_tpu_torch.obs`). An armed
  :class:`~metrics_tpu_torch.fault.FaultSchedule` poisons inputs there first
  (the ``input.poison`` site).
- ``save_checkpoint`` / ``restore_checkpoint``: durable, atomic checkpoints of every
  state (:mod:`~metrics_tpu_torch.ckpt`, the JAX package's format).

Observability: with the obs gate on, a wrapped update counts ``updates`` and
``dispatches``, is fingerprinted by the retrace detector
(:mod:`~metrics_tpu_torch.obs.recompile`) and runs in a ``tm.update/<Metric>`` range
(:mod:`~metrics_tpu_torch.obs.scopes`), where its hand-kernel launches count as its
``kernel_launches`` (which :func:`~metrics_tpu_torch.obs.crosscheck` holds against the
launch budget stamped on the card), and a compute counts ``computes`` in a
``tm.compute/<Metric>`` range; an update inside an engine's step (a capture, or its
eager run on the CPU) records nothing. The flight recorder (:mod:`~metrics_tpu_torch.obs.flight`) gets a
``dispatch`` event a wrapped update (with the covering flow's id while
:mod:`~metrics_tpu_torch.obs.flow` traces), a ``merge`` event a ``merge_state`` and a
``nonfinite_inputs`` event a quarantine that counted rows; ``state_report()`` gives the
states' dtypes, shapes, bytes and devices.

Plots: ``plot()`` draws the computed value (or the given ones) with matplotlib
(:mod:`~metrics_tpu_torch.utils.plot`), with the class's bounds, legend name and
``higher_is_better``.
"""
import functools
import inspect
import warnings
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch import _build
from metrics_tpu_torch.core.state import CatBuffer, cat_merge
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.fault.inject import PoisonedInputError
from metrics_tpu_torch.obs import flight as _obs_flight
from metrics_tpu_torch.obs import flow as _obs_flow
from metrics_tpu_torch.obs import recompile as _obs_recompile
from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.obs import scopes as _obs_scopes
from metrics_tpu_torch.parallel.collective import distributed_available
from metrics_tpu_torch.utils.data import (
    _flatten,
    _resolve_device,
    _same_device,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    to_tensor,
)
from metrics_tpu_torch.utils.checks import _is_concrete, in_step
from metrics_tpu_torch.utils.distributed import gather_all_tensors
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
        dist_sync_on_step: sync ``forward``'s batch value across processes too.
        process_group: the ``torch.distributed`` group to sync over (the default
            group when None).
        dist_sync_fn: the gather (``gather_all_tensors`` when None).
        distributed_available_fn: the gate of the sync (``distributed_available``
            when None: an initialised group of more than one process).
        sync_on_compute: sync before ``compute``.
        cat_capacity: keep each ``cat`` state as a ``CatBuffer`` of this many rows
            instead of a list.
        fleet_size: give every state a leading axis of this many streams
            (:mod:`~metrics_tpu_torch.core.fleet`); exclusive with ``cat_capacity``.
        nan_policy: what ``update`` does with input rows holding NaN/Inf: None (let
            them through), ``"count"``, ``"warn"`` or ``"raise"``.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    # the constructor arguments that shape ``update``'s state transition, for a
    # collection's compute groups (None: compare every constructor attribute)
    _update_signature_attrs: Optional[Tuple[str, ...]] = None
    # fleet axis: streams of the fleet, None for a plain metric
    fleet_size: Optional[int] = None
    # classes whose state shapes follow the first batch cannot take a fleet axis
    _lazy_state_shapes: bool = False
    # depth of running pure-tier calls (local_update): the fleet's eager dispatch
    # must not hand the caller's state to a captured graph's buffers
    _pure_call_depth: int = 0
    # update's inputs are host data (strings, dicts: the text metrics): the update
    # wrapper passes them on as they are, and the engines keep the class eager
    _host_side_update: bool = False
    # only compute reads the host (a flag to warn on, host draws, ragged curves): a
    # fused forward keeps the class eager, and tmlint (analysis/) does not take its
    # compute for a trace entry; update stays traced
    _host_side_compute: bool = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._device = _resolve_device(kwargs.pop("device", None))

        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")

        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(
                f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}"
            )
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(
                f"Expected keyword argument `dist_sync_fn` to be a callable or None but got {self.dist_sync_fn}"
            )
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(
                f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}"
            )

        self.cat_capacity = kwargs.pop("cat_capacity", None)
        if self.cat_capacity is not None and (not isinstance(self.cat_capacity, int) or self.cat_capacity < 1):
            raise ValueError(
                f"Expected keyword argument `cat_capacity` to be a positive int or None but got {self.cat_capacity}"
            )
        # what to do when NaN/Inf rows reach update(): None lets them through
        # untouched; "count", "warn" and "raise" tally them and escalate accordingly
        self.nan_policy = kwargs.pop("nan_policy", None)
        if self.nan_policy not in (None, "warn", "raise", "count"):
            raise ValueError(
                "Expected keyword argument `nan_policy` to be one of None,"
                f" 'warn', 'raise', 'count' but got {self.nan_policy!r}"
            )
        from metrics_tpu_torch.core import fleet as _fleet

        self.fleet_size = _fleet.validate_fleet_size(kwargs.pop("fleet_size", None))
        self._fleet_base_defaults: Dict[str, Tensor] = {}
        if self.fleet_size is not None and self.cat_capacity is not None:
            raise MetricsUserError(
                "fleet_size and cat_capacity are mutually exclusive: CatBuffer"
                " states have no per-stream segment fold"
            )
        if self.fleet_size is not None and type(self)._lazy_state_shapes:
            raise MetricsUserError(
                f"{type(self).__name__} initializes data-shaped state lazily on the"
                " first update (scalar placeholder -> map-shaped array), but the fleet"
                " axis requires every stream's state to keep the registered shape so"
                " rows can fold through one segment reduction"
            )
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._defaults: Dict[str, Union[Tensor, List, CatBuffer]] = {}
        # declared (item_shape, dtype, fill) of each cat state's rows
        self._cat_meta: Dict[str, tuple] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Any] = {}

        self._update_count = 0
        self._computed: Any = None
        self._forward_cache: Any = None
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None

        self.update: Callable = self._wrap_update(self.update)
        self.compute: Callable = self._wrap_compute(self.compute)

    # ------------------------------------------------------------------ state

    def add_state(
        self,
        name: str,
        default: Union[Tensor, list, float, int],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
        cat_item_shape: Sequence[int] = (),
        cat_dtype: Optional[torch.dtype] = None,
        cat_fill_value: Union[int, float] = 0,
    ) -> None:
        """Register a state: a tensor (reset value) or an empty list (a ``cat`` state).

        ``dist_reduce_fx`` is one of ``"sum" | "mean" | "max" | "min" | "cat" | None`` or
        a callable applied to a stacked ``(k, ...)`` tensor; ``forward`` and
        ``merge_state`` combine states with it.

        ``cat_item_shape`` / ``cat_dtype`` / ``cat_fill_value`` describe one row of a
        list state. With ``cat_capacity`` set, a ``"cat"`` list state becomes a
        ``CatBuffer`` of such rows, unused rows holding ``cat_fill_value``.
        """
        if not name.isidentifier():
            raise ValueError(f"Argument `name` must be a valid python identifier, got {name!r}")
        is_list = isinstance(default, list)
        if is_list and default:
            raise ValueError("Unexpected type of `default` value: list states must start empty")
        if dist_reduce_fx is not None and not (dist_reduce_fx in _REDUCE_KIND_TO_FN or callable(dist_reduce_fx)):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if is_list and self.fleet_size is not None:
            raise MetricsUserError(
                f"Fleet metrics cannot register list/cat state `{name}`: cat states are"
                " host-ragged or fixed-capacity buffers with no per-stream segment fold."
                " Use per-stream instances (or a sketch state) for cat-style metrics."
            )
        if is_list:
            self._cat_meta[name] = (tuple(cat_item_shape), cat_dtype, cat_fill_value)
        if is_list and self.cat_capacity is not None and dist_reduce_fx == "cat":
            default = CatBuffer.create(
                self.cat_capacity, tuple(cat_item_shape), cat_dtype or torch.float32, cat_fill_value, self._device
            )
            setattr(self, name, default.clone())
            self._defaults[name] = default
        elif is_list:
            setattr(self, name, [])
            self._defaults[name] = []
        else:
            default = torch.as_tensor(default).to(self._device)
            if self.fleet_size is not None:
                from metrics_tpu_torch.core import fleet as _fleet

                # the (N, *base) default; registers the _fleet_rows bookkeeping state
                default = _fleet.register_state(self, name, default, dist_reduce_fx)
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

    def state_pytree(self) -> Dict[str, Any]:
        """The live states as a dict: tensors as they are, lists copied, and each
        ``CatBuffer`` as a new buffer object over the same data."""
        out: Dict[str, Any] = {}
        for name, value in self.metric_state.items():
            if isinstance(value, CatBuffer):
                out[name] = value.copy()
            elif isinstance(value, list):
                out[name] = list(value)
            else:
                out[name] = value
        return out

    def _load_state(self, state: Dict[str, Any], copy_buffers: bool = True) -> None:
        for name, value in state.items():
            if isinstance(value, CatBuffer):
                # a copy for an update: appends write into the buffer in place, and
                # the caller's state must stay as it was (the pure contract)
                setattr(self, name, value.clone() if copy_buffers else value.copy())
            else:
                setattr(self, name, list(value) if isinstance(value, (list, tuple)) else value)

    # ------------------------------------------------- pure-functional tier

    def init_state(self) -> Dict[str, Any]:
        """The default state dict, pure: fresh tensors and buffers, never the
        registered defaults themselves."""
        out: Dict[str, Any] = {}
        for name, default in self._defaults.items():
            if isinstance(default, list):
                out[name] = []
            else:
                out[name] = default.clone()  # a CatBuffer's clone copies its data
        return out

    def local_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure state transition: ``update`` run on ``state``, returning the new state
        dict; the live state, ``_update_count`` and the compute cache of ``self`` are
        left as they were, and so is ``state``."""
        saved = {attr: getattr(self, attr) for attr in self._defaults}
        saved_count, saved_computed = self._update_count, self._computed
        self._pure_call_depth = self._pure_call_depth + 1
        try:
            self._load_state(state)
            self.update(*args, **kwargs)
            new_state = self.state_pytree()
        finally:
            self._pure_call_depth = self._pure_call_depth - 1
            for attr, val in saved.items():
                setattr(self, attr, val)
            self._update_count, self._computed = saved_count, saved_computed
        return new_state

    def sync_state(self, state: Dict[str, Any], group: Optional[Any] = None) -> Dict[str, Any]:
        """``state`` reduced over the ``torch.distributed`` process ``group`` by each
        state's ``dist_reduce_fx`` (all-reduce for sum/mean/max/min, a gather for the
        rest, ``cat_sync`` for a ``CatBuffer``); the identity for ``group=None``. Every
        rank of the group must call it."""
        from metrics_tpu_torch.parallel import collective

        return collective.sync_pytree(state, self._reductions, group, self._cat_meta, self._device)

    def compute_from(self, state: Dict[str, Any], group: Optional[Any] = None) -> Any:
        """Pure compute: ``state`` synced over ``group`` (unless None), then the value.

        Float outputs become NaN when a ``CatBuffer`` state overflowed on any rank."""
        if group is not None:
            state = self.sync_state(state, group)
        saved = {attr: getattr(self, attr) for attr in self._defaults}
        saved_computed, saved_count = self._computed, self._update_count
        try:
            self._load_state(state, copy_buffers=False)  # a compute appends nothing
            self._computed = None
            self._update_count = max(saved_count, 1)  # no not-updated warning
            value = self._compute_raw()
        finally:
            for attr, val in saved.items():
                setattr(self, attr, val)
            self._computed, self._update_count = saved_computed, saved_count
        return self._poison_if_overflowed(state, value)

    @staticmethod
    def _poison_if_overflowed(state: Dict[str, Any], value: Any) -> Any:
        """NaN in every float output when a ``CatBuffer`` state lost rows: a plausible
        but wrong number is worse. Integer outputs stay as they are."""
        if not any(v.overflowed() for v in state.values() if isinstance(v, CatBuffer)):
            return value
        return apply_to_collection(
            value, Tensor, lambda x: torch.full_like(x, float("nan")) if x.is_floating_point() else x
        )

    def _compute_raw(self) -> Any:
        """The subclass's compute, without cache or sync; a fleet's gives the
        per-stream value."""
        if self.fleet_size is not None:
            from metrics_tpu_torch.core import fleet as _fleet

            return _fleet.fleet_compute_value(self)
        return type(self).compute(self)

    def merge_state(self, other: Union["Metric", Dict[str, Any]]) -> None:
        """Merge another instance's state (or a state dict) into the live state, in place.

        Only reductions with a pairwise merge are accepted: ``sum``/``max``/``min``
        tensor states and ``cat`` list states; others, and ``CatBuffer`` states, raise
        :class:`MetricsUserError`.
        """
        if isinstance(other, Metric):
            if other.fleet_size != self.fleet_size:
                # before the per-state merge: two fleets of different size share
                # state names, and the sum would broadcast (N,) + (M,)
                raise MetricsUserError(
                    f"Cannot merge state of {type(other).__name__} into {type(self).__name__}:"
                    f" fleet sizes differ (fleet_size={other.fleet_size} vs"
                    f" fleet_size={self.fleet_size}); reduce_fleet() one side first"
                )
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
            if isinstance(mine, CatBuffer) or isinstance(theirs, CatBuffer):
                raise MetricsUserError(
                    f"merge_state: `{name}` is a CatBuffer state; fixed-capacity cat states"
                    " merge only through a cross-process gather (not ported yet)"
                )
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
        if _obs._ENABLED and _obs_flight._RING is not None:
            _obs_flight.record("merge", metric=type(self).__name__, incoming_updates=incoming_count)

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

    def _quarantine_inputs(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        """The ``nan_policy`` gate: count the input rows that hold NaN/Inf.

        Every float tensor's bad rows are summed on its device and read on the host
        once. Inside a captured or transformed step (the engines' chained steps,
        ``vmap``) the check is skipped, as the JAX package skips tracers.
        """
        counts = []
        for value in tuple(args) + tuple(kwargs.values()):
            if isinstance(value, np.ndarray) and np.issubdtype(value.dtype, np.floating):
                value = torch.from_numpy(value)
            if not isinstance(value, Tensor) or not value.is_floating_point() or value.numel() == 0:
                continue
            if not _is_concrete(value):
                return
            bad = ~torch.isfinite(value)
            counts.append(bad.sum() if value.dim() == 0 else bad.reshape(value.shape[0], -1).any(-1).sum())
        if not counts:
            return
        rows = int(sum(c.to(counts[0].device) for c in counts))  # the one host read
        if not rows:
            return
        name = type(self).__name__
        if _obs._ENABLED:
            _obs.REGISTRY.inc(name, "nonfinite_rows", rows)
            if _obs_flight._RING is not None:
                _obs_flight.record("nonfinite_inputs", metric=name, rows=rows, policy=self.nan_policy)
        if self.nan_policy == "raise":
            raise PoisonedInputError(name, rows)
        if self.nan_policy == "warn":
            rank_zero_warn(
                f"Metric {name}: {rows} update input row(s) contain NaN/Inf"
                " (nan_policy='warn'); they were accumulated anyway. Use"
                " nan_policy='raise' to reject poisoned batches.",
                MetricsUserWarning,
            )

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            if not self._host_side_update:
                args = tuple(self._check_device(a) for a in args)
                kwargs = {k: self._check_device(v) for k, v in kwargs.items()}
            # fault injection and the quarantine run before any bookkeeping: a rejected
            # batch leaves the states, the update count and the caches as they were
            if _fault._SCHEDULE is not None:
                args, kwargs = _fault.poison_inputs(args, kwargs, metric=type(self).__name__)
            if self.nan_policy is not None:
                self._quarantine_inputs(args, kwargs)
            self._computed = None
            self._update_count += 1
            if self.fleet_size is not None:
                from metrics_tpu_torch.core import fleet as _fleet

                # route or broadcast the batch to the streams through the raw update
                run = functools.partial(_fleet.apply_update, self, update, args, kwargs)
            else:
                run = functools.partial(update, *args, **kwargs)
            # one boolean on the disabled path; an update inside an engine's step (which
            # the JAX package traces with the gate off) records nothing either
            if _obs._ENABLED and not in_step():
                name = type(self).__name__
                _obs.REGISTRY.inc(name, "updates")
                _obs.REGISTRY.inc(name, "dispatches")
                if _obs_flight._RING is not None:
                    cur = _obs_flow.current() if _obs_flow._TRACER is not None else None
                    _obs_flight.record_dispatch(name, args, kwargs, flow_id=None if cur is None else cur.flow_id)
                _obs_recompile.check_update(self, args, kwargs)
                with _obs_scopes.update_scope(name), _build.crediting(name):
                    run()
            else:
                run()
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
            stream = kwargs.pop("stream", None)
            if stream is not None and self.fleet_size is None:
                raise MetricsUserError(
                    f"compute(stream={stream}) requires a fleet metric; construct with"
                    " Metric(fleet_size=N) or convert via .as_fleet(N)"
                )
            if stream is not None and not (0 <= stream < self.fleet_size):
                raise MetricsUserError(f"compute(stream={stream}) out of range for fleet_size={self.fleet_size}")
            if self._update_count == 0:
                rank_zero_warn(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    MetricsUserWarning,
                )
            if self._computed is not None:
                if _obs._ENABLED:
                    _obs.REGISTRY.inc(type(self).__name__, "compute_cache_hits")
                return self._computed if stream is None else _stream_of(self._computed, stream)
            for attr in self._defaults:
                val = getattr(self, attr)
                if isinstance(val, CatBuffer) and val.overflowed():
                    # every process warns: an overflow on any rank loses data
                    warnings.warn(
                        f"Metric {self.__class__.__name__}: cat state `{attr}` overflowed its"
                        f" capacity {val.capacity}; the computed value is missing the overwritten"
                        " rows. Increase `cat_capacity`.",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            with self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
            ):
                if self.fleet_size is not None:
                    # (N, ...) leaves stay unsqueezed, so compute(stream=0) indexes
                    compute_fn = self._compute_raw
                else:
                    compute_fn = functools.partial(compute, *args, **kwargs)
                if _obs._ENABLED:
                    name = type(self).__name__
                    _obs.REGISTRY.inc(name, "computes")
                    with _obs_scopes.compute_scope(name):
                        value = compute_fn()
                else:
                    value = compute_fn()
                self._computed = value if self.fleet_size is not None else _squeeze_if_scalar(value)
            return self._computed if stream is None else _stream_of(self._computed, stream)

        return wrapped_func

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the global state and return the metric's value on this batch alone.

        ``full_state_update`` picks the strategy: True (or None) runs ``update`` twice,
        once on the global state and once on a fresh one; False runs it once on a
        fresh state and merges that into the global state. With
        ``dist_sync_on_step`` the batch value is synced across processes (and the
        first strategy is taken), the global state stays local.
        """
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        if _obs._ENABLED:
            _obs.REGISTRY.inc(type(self).__name__, "forwards")
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            self._forward_cache = self._forward_full_state_update(*args, **kwargs)
        else:
            self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        return self._forward_cache

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        update_count = self._update_count
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        compute_on_cpu = self.compute_on_cpu
        self.compute_on_cpu = False
        cache = _held_states(self)
        # a wrapper's reset resets its child metrics: keep their accumulated states too
        # (the JAX package keeps only the wrapper's own, so its children lose theirs)
        children = [(m, _held_states(m), m._update_count) for m in self._child_metrics()]

        self.reset()
        self.update(*args, **kwargs)
        batch_val = self.compute()

        for attr, val in cache.items():
            setattr(self, attr, val)
        self._update_count = update_count
        for child, states, count in children:
            for attr, val in states.items():
                setattr(child, attr, val)
            child._update_count = count
            child._computed = None
        self._end_forward(compute_on_cpu)
        return batch_val

    def _child_metrics(self) -> List["Metric"]:
        """The metrics held inside this one (a wrapper's base metric or copies), at any depth."""
        return [m for m in self.modules() if isinstance(m, Metric) and m is not self]

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = _held_states(self)
        update_count = self._update_count
        self.reset()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        compute_on_cpu = self.compute_on_cpu
        self.compute_on_cpu = False

        self.update(*args, **kwargs)
        batch_val = self.compute()

        self._update_count = update_count + 1
        self._reduce_states(global_state)
        self._end_forward(compute_on_cpu)
        return batch_val

    def _end_forward(self, compute_on_cpu: bool) -> None:
        """Restore the sync bookkeeping after ``forward``'s batch compute (whose synced
        view, if any, was replaced by the global state)."""
        self._is_synced = False
        self._cache = None
        self._should_unsync = True
        self._to_sync = self.sync_on_compute
        self._computed = None
        self.compute_on_cpu = compute_on_cpu
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()

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
            elif reduce_fn == "cat" and isinstance(global_state, CatBuffer):
                reduced = cat_merge(global_state, local_state)
            elif reduce_fn == "cat" or (reduce_fn is None and isinstance(global_state, list)):
                reduced = list(global_state) + list(local_state)
            elif reduce_fn is None:
                reduced = torch.stack([global_state, local_state])
            elif callable(reduce_fn):
                reduced = reduce_fn(torch.stack([global_state, local_state]))
            else:
                raise TypeError(f"Unsupported reduce_fn: {reduce_fn}")
            setattr(self, attr, reduced)

    # ------------------------------------------------------------------- sync

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        """Gather every state from every process, stack, and reduce by its ``dist_reduce_fx``.

        A ``cat`` list goes across as one concatenated tensor, an empty one as a
        ``(0, *item_shape)`` tensor of its declared dtype, so that every rank joins
        every gather; it comes back as ``[]`` when every rank's was empty. A
        ``CatBuffer`` goes across as its valid rows; the synced view is a dense
        tensor, and ``unsync`` restores the live buffer.
        """
        dist_sync_fn = dist_sync_fn or gather_all_tensors
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        was_list = {attr for attr, value in input_dict.items() if isinstance(value, list)}

        for attr, reduction_fn in self._reductions.items():
            value = input_dict[attr]
            if isinstance(value, CatBuffer):
                input_dict[attr] = [value.values()]
            elif isinstance(value, list) and not value:
                item_shape, dtype, _ = self._cat_meta.get(attr, ((), None, 0))
                input_dict[attr] = [torch.empty((0, *item_shape), dtype=dtype or torch.float32, device=self._device)]
            elif reduction_fn == "cat" and isinstance(value, list) and len(value) > 1:
                input_dict[attr] = [dim_zero_cat(value)]

        output_dict = apply_to_collection(input_dict, Tensor, dist_sync_fn, group=process_group or self.process_group)

        for attr, reduction_fn in self._reductions.items():
            output = output_dict[attr]
            if isinstance(output[0], Tensor):
                output = torch.stack(output)
            elif isinstance(output[0], list):
                output = _flatten(output)
                if attr in was_list and all(t.numel() == 0 for t in output):
                    setattr(self, attr, [])
                    continue

            if reduction_fn is None:
                reduced = output
            elif isinstance(reduction_fn, str):
                reduced = _REDUCE_KIND_TO_FN[reduction_fn](output)
            elif callable(reduction_fn):
                reduced = reduction_fn(output)
            else:
                raise TypeError("reduction_fn must be callable or None")
            setattr(self, attr, reduced)

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Replace the live states by their sync across processes, keeping the live
        ones for :meth:`unsync`. Does nothing unless ``should_sync`` and the gate
        (``distributed_available``, else the metric's ``distributed_available_fn``)
        say so; a second sync before ``unsync`` raises."""
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        if distributed_available is None and self.distributed_available_fn is not None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return

        self._cache = {attr: getattr(self, attr) for attr in self._defaults}
        if _obs._ENABLED:
            _obs.REGISTRY.inc(type(self).__name__, "syncs")
        self._sync_dist(dist_sync_fn or gather_all_tensors, process_group=process_group or self.process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the live states that :meth:`sync` kept."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        for attr, val in self._cache.items():
            setattr(self, attr, val)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator[None, None, None]:
        """Sync on entry and unsync on exit, also when the body raises."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        try:
            yield
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    def reset(self) -> None:
        """Restore the default states."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr, default in self._defaults.items():
            setattr(self, attr, [] if isinstance(default, list) else default.clone())  # CatBuffer: a fresh buffer
        self._cache = None
        self._is_synced = False

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    # ----------------------------------------------------------------- fleet

    def as_fleet(self, fleet_size: int) -> "Metric":
        """A fleet copy of this metric: every state gains a leading ``(fleet_size,
        ...)`` stream axis holding the live value in every stream, and ``update``
        takes ``stream_ids``. Raises :class:`MetricsUserError` for a list/cat state or
        a reduction other than sum/max/min."""
        from metrics_tpu_torch.core import fleet as _fleet

        if self.fleet_size is not None:
            raise MetricsUserError(f"{type(self).__name__} is already a fleet (fleet_size={self.fleet_size})")
        out = deepcopy(self)
        _fleet.convert_to_fleet(out, fleet_size)
        return out

    def reduce_fleet(self) -> Any:
        """The value over all streams: the fleet axis collapsed by each state's
        reduction (the ``merge_state`` algebra), then computed."""
        from metrics_tpu_torch.core import fleet as _fleet

        if self.fleet_size is None:
            raise MetricsUserError(f"reduce_fleet() requires a fleet metric; {type(self).__name__} has no fleet axis")
        return _fleet.reduce_fleet_value(self)

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
            if isinstance(value, CatBuffer):
                data = value.data if keep_vars else value.data.detach().clone()
                destination[prefix + key] = {"data": data, "count": value.count, "overflow": value.overflow}
            elif isinstance(value, list):
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
                if isinstance(value, dict) and {"data", "count"} <= set(value):
                    data = torch.as_tensor(value["data"]).to(self._device)
                    setattr(self, key, CatBuffer(data, value["count"], value.get("overflow", False)))
                elif isinstance(value, list):
                    setattr(self, key, [torch.as_tensor(v).to(self._device) for v in value])
                else:
                    setattr(self, key, torch.as_tensor(value).to(self._device, self._defaults[key].dtype))
        self._computed = None
        super()._load_from_state_dict(
            state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
        )

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        """Move defaults, list and ``CatBuffer`` states with the buffers (``.to``, ``.cuda``, ``.cpu``)."""
        super()._apply(fn, *args, **kwargs)

        def move(v: Any) -> Any:
            if isinstance(v, list):
                return [fn(t) for t in v]
            return v.apply(fn) if isinstance(v, CatBuffer) else fn(v)

        self._defaults = {k: move(v) for k, v in self._defaults.items()}
        self._fleet_base_defaults = {k: fn(v) for k, v in self._fleet_base_defaults.items()}
        for key, default in self._defaults.items():
            if not isinstance(default, Tensor):
                setattr(self, key, move(getattr(self, key)))
        for default in self._defaults.values():
            if isinstance(default, (Tensor, CatBuffer)):
                self._device = default.device
                break
        else:  # no state of its own (a wrapper): the device of the metrics it holds
            self._device = next((m.device for m in self._child_metrics()), self._device)
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

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot a value of the metric, or a list of them (a series over steps);
        ``compute()`` by default. Returns ``(figure, axis)``."""
        return self._plot(val, ax)

    def _plot(self, val: Any = None, ax: Any = None) -> Any:
        from metrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            name=self.__class__.__name__,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
        )

    def state_report(self) -> Dict[str, Any]:
        """One row a registered state: dtype, shape, nbytes, device, and for a
        ``CatBuffer`` its fill against its capacity (:mod:`~metrics_tpu_torch.obs.report`;
        render with :func:`~metrics_tpu_torch.utils.prints.render_state_report`)."""
        from metrics_tpu_torch.obs.report import metric_state_report

        return metric_state_report(self)

    def save_checkpoint(self, directory: str, step: Optional[int] = None, **kwargs: Any) -> Any:
        """Write a durable, atomic checkpoint of the whole state: every registered state
        (``persistent_only=True`` for ``state_dict``'s subset), ``CatBuffer`` counts
        and overflow flags, child metrics and the update count. See
        :func:`metrics_tpu_torch.ckpt.save_checkpoint` for ``blocking``, ``retain`` and
        the options for many hosts; returns its
        :class:`~metrics_tpu_torch.ckpt.CheckpointWrite`."""
        from metrics_tpu_torch.ckpt import save_checkpoint

        return save_checkpoint(self, directory, step=step, **kwargs)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None, **kwargs: Any) -> int:
        """Load a checkpoint of :meth:`save_checkpoint` (or of the JAX package's) into
        this metric, after validating it against this metric (typed
        :mod:`~metrics_tpu_torch.ckpt` errors on drift, corruption or partial writes;
        never half-loaded). Returns the restored step."""
        from metrics_tpu_torch.ckpt import restore_checkpoint

        return restore_checkpoint(self, directory, step=step, **kwargs)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """The keyword arguments that ``update`` takes (all of them if it takes ``**kwargs``)."""
        params = _class_update_signature(type(self)).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        skip = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        filtered = {k: v for k, v in kwargs.items() if k in params and params[k].kind not in skip}
        if self.fleet_size is not None and "stream_ids" in kwargs:
            # the fleet's routing argument, taken by the wrapped update itself
            filtered["stream_ids"] = kwargs["stream_ids"]
        return filtered

    def __hash__(self) -> int:
        # identity, as for any module: ``__eq__`` below builds a metric, not a bool
        return object.__hash__(self)

    # --------------------------------------------------- operator composition

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.subtract, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.subtract, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.multiply, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.multiply, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return self.__inv__()

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    def __iter__(self):
        raise NotImplementedError("Metrics does not support iteration.")


def _held_states(metric: Metric) -> Dict[str, Any]:
    """The live states that ``forward`` keeps across its batch step. A captured step's
    static buffer (a fleet's, a stacked BootStrapper's, a fused collection's state after
    a replay) is copied: the batch's own replay writes into it."""
    from metrics_tpu_torch.core.fused import is_step_buffer

    return {attr: v.clone() if is_step_buffer(v) else v for attr, v in metric.metric_state.items()}


def _stream_of(value: Any, stream: int) -> Any:
    from metrics_tpu_torch.core import fleet as _fleet

    return _fleet.index_stream(value, stream)


@functools.lru_cache(maxsize=None)
def _class_update_signature(cls: type) -> inspect.Signature:
    return inspect.signature(cls.update)


def _neg(x: Tensor) -> Tensor:
    # the JAX package's (and its reference's) negation: minus the absolute value
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """The value of ``operator`` over two metrics or constants (one for a unary
    operator), computed lazily from each metric's own state.

    ``update`` updates each metric operand; ``compute`` applies ``operator`` to
    their values; ``reset`` and ``persistent`` reach the operands. Each operand
    syncs itself, so the composition has nothing of its own to sync. It lives on
    its first metric operand's device, and number operands become tensors there.
    """

    full_state_update = True

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor, None],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        device = next((m.device for m in (metric_a, metric_b) if isinstance(m, Metric)), None)
        super().__init__(device=device)
        self.op = operator
        self.metric_a = torch.tensor(metric_a, device=self._device) if isinstance(metric_a, (int, float)) else metric_a
        self.metric_b = torch.tensor(metric_b, device=self._device) if isinstance(metric_b, (int, float)) else metric_b

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None or (val_b is None and isinstance(self.metric_b, Metric)):
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = getattr(self.op, "__name__", "op")
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute
