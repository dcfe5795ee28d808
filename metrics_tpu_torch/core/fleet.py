"""Fleet-axis metric runtime: one state tree and one step for N streams.

Counterpart of ``metrics_tpu/core/fleet.py``. A fleet metric keeps every registered
state with a leading stream axis ``(N, *base)`` and routes a mixed batch to its
streams in one step:

- ``Metric(fleet_size=N)`` (or ``metric.as_fleet(N)``) repeats every ``add_state``
  default to ``(N, *base)`` and registers a ``_fleet_rows`` state, the rows routed
  to each stream (int32, ``sum``).
- ``update(batch, stream_ids=ids)`` runs the metric's own update on every row as a
  batch of one, under ``torch.func.vmap`` over per-row unit states, and folds the
  units into the fleet state by the registered reduction: ``index_add_`` of each
  unit's change from the default for ``sum``, ``scatter_reduce`` (``amax``/``amin``,
  the current state included) for ``max``/``min``, so that an empty stream keeps
  what it had. A histogram under the ``vmap`` is one launch of the kernel's batched
  mode (:mod:`~metrics_tpu_torch.ops.histogram`). ``update(batch)`` without ids
  gives the batch to every stream (``vmap`` over the state rows).
- ``compute()`` gives the per-stream value from one ``vmap`` over the state rows
  (a per-stream loop where a compute cannot be vmapped), ``compute(stream=i)`` one
  stream's, ``reduce_fleet()`` the value over all streams.

On a CUDA device each step is captured once per key (tag, state and input shapes
and dtypes, static inputs) into a CUDA graph and replayed, through the fused
engine's :class:`~metrics_tpu_torch.core.fused.StepCache`; on the CPU it runs
eagerly. A capture that fails leaves that key on the eager step, with a
``RuntimeWarning`` and a count in the metric's :func:`step_stats` (``degrades``).

Eligibility: fleet states are fixed-shape tensors with a ``sum``/``max``/``min``
reduction; list, ``cat`` and ``CatBuffer`` states and other reductions raise
:class:`MetricsUserError` at ``add_state``. The routing is exact for integer counts
and reorders float sums (ulp-level differences).
"""
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from metrics_tpu_torch.core.metric import _squeeze_if_scalar
from metrics_tpu_torch.utils.checks import _is_concrete, tracing
from metrics_tpu_torch.utils.exceptions import MetricsUserError

# bookkeeping state: rows routed per stream, shape (fleet_size,), int32, "sum"
ROWS_STATE = "_fleet_rows"

# reductions with an exact (or associative) per-row fold, as merge_state's
FLEET_REDUCTIONS = ("sum", "max", "min")


# ------------------------------------------------------------- registration


def validate_fleet_size(fleet_size: Any) -> Optional[int]:
    if fleet_size is None:
        return None
    if isinstance(fleet_size, bool) or not isinstance(fleet_size, int) or fleet_size < 1:
        raise ValueError(f"Expected keyword argument `fleet_size` to be a positive int or None but got {fleet_size!r}")
    return fleet_size


def register_state(metric: Any, name: str, default: Tensor, reduce_kind: Any) -> Tensor:
    """Fleet hook of ``Metric.add_state`` for a tensor state: check its reduction,
    keep the base default, make sure the rows state exists, and return the
    ``(N, *base)`` default."""
    if reduce_kind not in FLEET_REDUCTIONS:
        raise MetricsUserError(
            f"Fleet metrics require a sum/max/min reduction for state `{name}`, got"
            f" {reduce_kind!r}: only those have the exact per-row fold stream routing"
            " relies on (the same pairwise algebra as merge_state)."
        )
    ensure_rows_state(metric)
    metric._fleet_base_defaults[name] = default
    return _replicate(default, metric.fleet_size)


def _replicate(value: Tensor, n: int) -> Tensor:
    """``value`` repeated along a new leading axis of ``n``, materialized."""
    return value.unsqueeze(0).repeat(n, *([1] * value.dim()))


def ensure_rows_state(metric: Any) -> None:
    """Register the ``_fleet_rows`` state directly (not through ``add_state``, whose
    fleet hook would take it as a base state)."""
    if ROWS_STATE in metric._defaults:
        return
    rows = torch.zeros(metric.fleet_size, dtype=torch.int32, device=metric.device)
    metric.register_buffer(ROWS_STATE, rows.clone(), persistent=False)
    metric._defaults[ROWS_STATE] = rows
    metric._persistent[ROWS_STATE] = False
    metric._reductions[ROWS_STATE] = "sum"


def convert_to_fleet(metric: Any, fleet_size: int) -> None:
    """Turn a (deep-copied) plain metric into a fleet, in place: the live value of
    every state is repeated into all ``fleet_size`` streams."""
    n = validate_fleet_size(fleet_size)
    for name, default in metric._defaults.items():
        if not isinstance(default, Tensor):
            raise MetricsUserError(
                f"{type(metric).__name__} cannot become a fleet: state `{name}` is a"
                " list/cat state (no per-stream segment fold)."
            )
        if metric._reductions[name] not in FLEET_REDUCTIONS:
            raise MetricsUserError(
                f"{type(metric).__name__} cannot become a fleet: state `{name}` has"
                f" reduction {metric._reductions[name]!r} (fleet states need sum/max/min)."
            )
    metric.fleet_size = n
    metric._fleet_base_defaults = {}
    for name in list(metric._defaults):
        base_default = metric._defaults[name]
        metric._fleet_base_defaults[name] = base_default
        metric._defaults[name] = _replicate(base_default, n)
        setattr(metric, name, _replicate(getattr(metric, name), n))
    ensure_rows_state(metric)
    metric._computed = None


def base_state_names(metric: Any) -> List[str]:
    return [n for n in metric._defaults if n != ROWS_STATE]


# --------------------------------------------------------------- pure paths


def _base_apply(metric: Any, raw_update: Callable, base_state: Dict[str, Any], args: Tuple, kwargs: Dict) -> Dict:
    """The raw subclass update run on a base-shaped state dict, purely with respect
    to the live state of ``metric`` (the wrapped update would count and recurse)."""
    saved = {attr: getattr(metric, attr) for attr in metric._defaults}
    saved_count, saved_computed = metric._update_count, metric._computed
    try:
        for name, value in base_state.items():
            setattr(metric, name, value)
        raw_update(*args, **kwargs)
        return {name: getattr(metric, name) for name in base_state}
    finally:
        for attr, val in saved.items():
            setattr(metric, attr, val)
        metric._update_count, metric._computed = saved_count, saved_computed


def _batch_rows(dyn: List[Tensor]) -> int:
    """The leading dim that the tensor inputs share (0 when none has one)."""
    dims = {int(d.shape[0]) for d in dyn if d.dim() >= 1}
    if len(dims) > 1:
        raise MetricsUserError(
            f"Fleet routing requires every array input to share the batch axis 0; got leading dims {sorted(dims)}"
        )
    return dims.pop() if dims else 0


def _check_stream_ids(ids: Tensor, rows: int) -> None:
    if ids.dim() != 1:
        raise MetricsUserError(f"stream_ids must be 1-D (one id per batch row), got shape {tuple(ids.shape)}")
    if ids.is_floating_point() or ids.is_complex() or ids.dtype == torch.bool:
        raise MetricsUserError(f"stream_ids must be integer, got dtype {ids.dtype}")
    if rows != int(ids.shape[0]):
        raise MetricsUserError(f"stream_ids has {int(ids.shape[0])} entries but the batch has {rows} rows")


def routed_new_state(
    metric: Any, raw_update: Callable, state: Dict[str, Tensor], args: Tuple, kwargs: Dict, stream_ids: Tensor
) -> Dict[str, Tensor]:
    """Pure fleet transition for a routed batch: the base update vmapped over
    per-row unit states, then the units folded into the fleet state."""
    from metrics_tpu_torch.core import fused as _fused

    n = metric.fleet_size
    dyn, spec = _fused._split_inputs(args, kwargs)
    rows = _batch_rows(dyn)
    _check_stream_ids(stream_ids, rows)
    base = metric._fleet_base_defaults
    names = base_state_names(metric)
    batched = [d.dim() >= 1 for d in dyn]
    # the unit defaults go in as a batched (rows, *base) argument: updates rebind
    # their states, and an unbatched default must never be written to
    unit_defaults = {name: _replicate(base[name], rows) for name in names}

    def unit(row_state: Dict[str, Tensor], row_dyn: List[Tensor]) -> Dict[str, Tensor]:
        # each row is a batch of one: the update sees its batch axis again
        a, k = _fused._merge_inputs([d.unsqueeze(0) if b else d for d, b in zip(row_dyn, batched)], spec)
        return _base_apply(metric, raw_update, row_state, a, k)

    in_dims = (0, [0 if b else None for b in batched])
    # an update that draws (BootStrapper's resample) draws once for the rows alike
    units = torch.func.vmap(unit, in_dims=in_dims, randomness="same")(unit_defaults, dyn) if rows else {}

    idx = stream_ids.to(torch.int64)
    new: Dict[str, Tensor] = {}
    for name, reduce_kind in metric._reductions.items():
        old = state[name]
        if name == ROWS_STATE:
            ones = torch.ones(rows, dtype=old.dtype, device=old.device)
            new[name] = old + torch.zeros_like(old).index_add_(0, idx, ones)
        elif not rows:
            new[name] = old
        elif reduce_kind == "sum":
            delta = units[name] - base[name]
            new[name] = old + torch.zeros(old.shape, dtype=delta.dtype, device=old.device).index_add_(0, idx, delta)
        else:  # "max" / "min": the current state takes part, so an empty stream keeps it
            value = units[name].to(old.dtype)
            where = idx.view(-1, *([1] * (value.dim() - 1))).expand_as(value)
            new[name] = old.scatter_reduce(0, where, value, "amax" if reduce_kind == "max" else "amin")
    return new


def broadcast_new_state(
    metric: Any, raw_update: Callable, state: Dict[str, Tensor], args: Tuple, kwargs: Dict
) -> Dict[str, Tensor]:
    """Pure fleet transition without ``stream_ids``: every stream sees the batch."""
    from metrics_tpu_torch.core import fused as _fused

    dyn, spec = _fused._split_inputs(args, kwargs)
    rows = _batch_rows(dyn)

    def one(row_state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        a, k = _fused._merge_inputs(dyn, spec)
        return _base_apply(metric, raw_update, row_state, a, k)

    # every stream sees the batch, and an update's draws (BootStrapper's resample) alike
    new = torch.func.vmap(one, randomness="same")({name: state[name] for name in base_state_names(metric)})
    new[ROWS_STATE] = state[ROWS_STATE] + rows
    return {name: new[name] for name in state}  # the state's own order: a captured step keeps its structure


def _base_apply_compute(metric: Any, base_state: Dict[str, Any]) -> Any:
    saved = {attr: getattr(metric, attr) for attr in metric._defaults}
    saved_count, saved_computed = metric._update_count, metric._computed
    try:
        for name, value in base_state.items():
            setattr(metric, name, value)
        metric._computed = None
        metric._update_count = max(saved_count, 1)
        # squeezed like the wrapped compute, so a stream's slice is shaped like an
        # independent metric's value
        return _squeeze_if_scalar(type(metric).compute(metric))
    finally:
        for attr, val in saved.items():
            setattr(metric, attr, val)
        metric._update_count, metric._computed = saved_count, saved_computed


def fleet_compute_value(metric: Any) -> Any:
    """Per-stream compute value from one ``vmap`` over the state rows.

    A compute that reads values on the host cannot be vmapped (``vmap`` raises a
    ``RuntimeError``); it runs once per stream instead. The update, the hot path,
    is not affected.
    """
    names = base_state_names(metric)
    state = {name: getattr(metric, name) for name in names}
    try:
        return torch.func.vmap(lambda row: _base_apply_compute(metric, row))(state)
    except RuntimeError:
        rows = [_base_apply_compute(metric, {name: state[name][i] for name in names}) for i in range(metric.fleet_size)]
        values, spec = zip(*(pytree.tree_flatten(r) for r in rows))
        return pytree.tree_unflatten([torch.stack(leaves) for leaves in zip(*values)], spec[0])


def reduce_fleet_value(metric: Any) -> Any:
    """The fleet axis collapsed through the registered reductions (the algebra of
    ``merge_state``), then computed."""
    collapsed: Dict[str, Tensor] = {}
    for name in base_state_names(metric):
        value = getattr(metric, name)
        reduce_kind = metric._reductions[name]
        if reduce_kind == "sum":
            # the streams add their change from the default; one default is added back
            base = metric._fleet_base_defaults[name]
            collapsed[name] = base + torch.sum(value - base.unsqueeze(0), dim=0)
        elif reduce_kind == "max":
            collapsed[name] = torch.amax(value, dim=0)
        else:
            collapsed[name] = torch.amin(value, dim=0)
    return _base_apply_compute(metric, collapsed)


def index_stream(value: Any, stream: Optional[int]) -> Any:
    """One stream's slice of a per-stream compute value (the value itself for None)."""
    if stream is None:
        return value
    return pytree.tree_map(lambda x: x[stream] if isinstance(x, Tensor) else x, value)


# ------------------------------------------------------------- step cache

# captured steps keyed by id(metric): a metric's ``==`` builds a metric, so it
# cannot key a weak dictionary; a finalizer drops the entry with the metric, and
# nothing lands on the instance (deepcopy and pickle stay as they were)
_STEP_CACHE: Dict[int, Any] = {}


def _steps_for(metric: Any) -> Any:
    from metrics_tpu_torch.core.fused import StepCache

    key = id(metric)
    steps = _STEP_CACHE.get(key)
    if steps is None:
        steps = _STEP_CACHE[key] = StepCache("fleet")
        weakref.finalize(metric, _STEP_CACHE.pop, key, None)
    return steps


def step_stats(metric: Any) -> Dict[str, int]:
    """The fleet metric's captured steps: ``launches`` (replays), ``cache_hits``,
    ``cache_misses`` and ``degrades`` (keys whose capture or replay failed and that
    run eagerly since)."""
    return dict(_steps_for(metric).stats)


def run_step(
    metric: Any,
    tag: str,
    step: Callable,
    state: Dict[str, Tensor],
    *extras: Any,
    static_key: Tuple = (),
    eager: bool = False,
):
    """Run a pure ``step(state, *extras) -> new_state``.

    On a CUDA device, through a CUDA graph captured once per key and replayed, its
    new state in the graph's static buffers. Eagerly on the CPU, inside another
    capture or transform, inside ``local_update`` (whose caller owns the state it
    gets back, where a graph's buffers are overwritten by its next replay), and with
    ``eager`` (a step with effects outside its state, which a replay would not redo).
    """
    from metrics_tpu_torch.core import fused as _fused

    device = _fused._step_device(state)
    nested = (
        eager
        or metric._pure_call_depth > 0
        or torch._C._are_functorch_transforms_active()
        or (device is not None and device.type == "cuda" and torch.cuda.is_current_stream_capturing())
    )
    if device is None or device.type != "cuda" or nested:
        with tracing():
            return step(state, *extras)
    key = (tag, _fused._tensor_key(state), _fused._tensor_key(list(extras)), static_key)
    out = _steps_for(metric).call(
        key,
        lambda: lambda st, *ex: (step(st, *ex), None),
        state,
        extras,
        f"the {tag} step for this signature runs eagerly from now on.",
    )
    if out is None:
        with tracing():
            return step(state, *extras)
    return out[0]


# --------------------------------------------------------- update interface


def apply_update(metric: Any, raw_update: Callable, args: Tuple, kwargs: Dict) -> None:
    """The fleet body of ``Metric``'s wrapped update: take ``stream_ids`` out, route
    or broadcast the batch in one step, and point the live state at the result."""
    from metrics_tpu_torch.core import fused as _fused

    kwargs = dict(kwargs)
    stream_ids = kwargs.pop("stream_ids", None)
    if stream_ids is not None and not getattr(type(metric), "_fleet_routes_rows", True):
        raise MetricsUserError(
            f"{type(metric).__name__} takes no stream_ids: its streams share one base metric, so every"
            " update goes to all of them; update without stream_ids"
        )
    state = {name: getattr(metric, name) for name in metric._defaults}
    dyn, spec = _fused._split_inputs(args, kwargs)
    # a wrapper's update is not pure over its registered state (it updates its child
    # metrics, or draws as BootStrapper's resample does): a graph would replay the
    # capture's effects, so its step runs eagerly (as the fused engine demotes it)
    eager = bool(metric._child_metrics())
    if stream_ids is None:

        def bcast(st, dl):
            a, k = _fused._merge_inputs(dl, spec)
            return broadcast_new_state(metric, raw_update, st, a, k)

        new = run_step(metric, "fleet.bcast", bcast, state, dyn, static_key=_fused._static_key(spec), eager=eager)
    else:
        ids = stream_ids if isinstance(stream_ids, Tensor) else torch.as_tensor(stream_ids, device=metric.device)
        _check_stream_ids(ids, _batch_rows(dyn))
        if ids.numel() and _is_concrete(ids):
            # one host read: an id outside the fleet would drop silently in the fold
            lo, hi = (int(v) for v in torch.stack(torch.aminmax(ids)).tolist())
            if lo < 0 or hi >= metric.fleet_size:
                raise MetricsUserError(f"stream_ids must lie in [0, {metric.fleet_size}), got range [{lo}, {hi}]")

        def route(st, dl, i_):
            a, k = _fused._merge_inputs(dl, spec)
            return routed_new_state(metric, raw_update, st, a, k, i_)

        new = run_step(metric, "fleet.route", route, state, dyn, ids, static_key=_fused._static_key(spec), eager=eager)
    metric._load_state(new)
