"""Fused ``MetricCollection.update``: one CUDA-graph replay per step.

Counterpart of ``metrics_tpu/core/fused.py``, where the compute-group leaders'
``local_update`` calls are chained into one jitted XLA program whose state tree is
donated. Here the same chain is captured once into a ``torch.cuda.CUDAGraph`` and
replayed:

- **One replay.** ``MetricCollection(..., fused=True)`` routes ``update`` (and
  ``forward``) through :class:`FusedCollectionUpdate`. A pure step ``new_states =
  f(states, *inputs)`` chains every fusable leader's ``local_update``; on a CUDA
  device it is captured into one graph per key (mode, group topology, state shapes
  and dtypes, input shapes and dtypes, and the static inputs), and each later step
  with that key is one ``replay``.
- **Static buffers.** Each key owns static input buffers, into which a step's
  inputs are copied, and static state buffers, into which the graph copies the new
  states at its end. After each replay the leaders (and their compute-group
  members) are re-pointed at the state buffers; before each replay a leader whose
  live state is not its buffer (after ``reset``, ``load_state_dict``,
  ``merge_state``, ``.to()`` or a regrouping) has it copied in once. This is the
  torch meaning of the JAX package's state gathering and donation: a tensor taken
  from a fused leader's state before a step is overwritten by that step, where the
  JAX package deletes the donated buffer.
- **Warm-up.** Before a capture the step runs once eagerly on a side stream, so the
  kernels' one-time work (the histogram kernel caches its grid and raises its
  shared-memory limit at its first launch) happens outside the graph.
- **Partial fusion.** Groups that cannot fuse (see :func:`fusion_fallback_reason`)
  stay on the eager per-group path, with a count in ``stats["fallback_groups"]``.
  When the chained step's first capture fails, each group is captured alone once
  to find the ones at fault; those stay eager for good, with a ``RuntimeWarning``.
  A capture of the rest or a replay that fails demotes that key's groups
  (``stats["degrades"]``). Nothing falls back to the CPU or to a plain kernel.
- **Launch counts.** A kernel wrapper called inside a capture only records its
  launch; :class:`CapturedStep` takes back the count it added there and adds it
  again at each replay, so that the wrappers' ``launches`` count what ran.
- **The CPU.** A collection on the CPU (``device="cpu"``) runs the same chained pure
  step eagerly, each step: the engines' plain version. Value checks are skipped in
  a step on either device (:func:`~metrics_tpu_torch.utils.checks.tracing`), as
  under ``jit``.

- **Faults.** The ``fused.compile`` and ``fused.launch`` sites of
  :mod:`~metrics_tpu_torch.fault` (``fleet.compile`` for the fleet) sit before a
  capture and before a replay: a fired fault breaks the key like a real failure,
  and the step runs eagerly, bit-equal, from then on.
- **Threads.** A capture is thread-local (``capture_error_mode="thread_local"``):
  another thread may use the card meanwhile (the ingest queue's producers, while its
  tick thread captures).

``stats`` keeps the JAX package's keys: ``launches`` (fused steps run: replays on
the card), ``cache_hits``, ``cache_misses``, ``fallback_groups`` and ``degrades``.
The observability and warm-manifest hooks of the JAX file are not ported.
"""
import inspect
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from metrics_tpu_torch import _build
from metrics_tpu_torch.core.metric import Metric, _class_update_signature, _squeeze_if_scalar
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.utils.checks import tracing
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = [
    "CapturedStep",
    "FusedCollectionUpdate",
    "StepCache",
    "engine_for",
    "fusion_fallback_reason",
    "canonical_collection",
]

#: placeholder of a dynamic (tensor) leaf in a flattened input
_DYN = object()

#: (site, error class) pairs already warned about: a broken key repeats every step
_DEGRADE_WARNED: set = set()


def _warn_degrade_once(site: str, err: Exception, detail: str) -> None:
    """One warning per (site, error class) that a step left the fused path."""
    key = (site, type(err).__name__)
    if key in _DEGRADE_WARNED:
        return
    _DEGRADE_WARNED.add(key)
    warnings.warn(
        f"metrics_tpu_torch degraded mode: {site} failed"
        f" ({type(err).__name__}: {str(err).splitlines()[0][:200] if str(err) else ''}); {detail}"
        " Further failures of this class stay silent; see the engine's `degrades` count.",
        RuntimeWarning,
        stacklevel=4,
    )


# ------------------------------------------------------------- eligibility


def fusion_fallback_reason(leader: Metric, members: Sequence[Metric] = (), forward: bool = False) -> Optional[str]:
    """Why this compute group cannot fuse (None: it can).

    The JAX package's static checks, and one more: a ``CatBuffer`` state, whose
    count the port keeps on the host, so that an append captured in a graph would
    write at the offset fixed at capture time.
    """
    if getattr(type(leader), "_host_side_update", False):
        return "update is host-side by contract (_host_side_update)"
    if not leader._defaults:
        return "no registered state (nothing to chain)"
    if leader.compute_on_cpu:
        return "compute_on_cpu moves state off-device after every update"
    values = [getattr(leader, n) for n in leader._defaults]
    if any(isinstance(v, list) for v in values):
        return "list ('cat') state without cat_capacity is host-ragged"
    if any(isinstance(v, CatBuffer) for v in values):
        return "CatBuffer state: its append offset is a host count, fixed in a captured graph"
    if any(getattr(m, "nan_policy", None) for m in members or (leader,)):
        return "nan_policy quarantine is a host-side input check in the update wrapper"
    if leader._child_metrics():
        return "holds child metrics (wrapper updates are not pure over registered state)"
    if forward:
        if any(m.dist_sync_on_step for m in members or (leader,)):
            return "dist_sync_on_step forwards sync eagerly inside the step"
        if any(getattr(type(m), "_host_side_compute", False) for m in members or (leader,)):
            return "a member's compute is host-side by contract (_host_side_compute)"
    return None


def _check_update_arity(name: str, metric: Metric, args: Tuple[Any, ...]) -> None:
    """Raise a typed, actionable error when the positional inputs cannot bind to
    ``metric.update`` (positional arguments go to every member as they are)."""
    params = [p for p in _class_update_signature(type(metric)).parameters.values() if p.name != "self"]
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
        return
    positional = [
        p for p in params if p.kind in (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ]
    if len(args) > len(positional):
        names = ", ".join(p.name for p in positional) or "<none>"
        raise MetricsUserError(
            f"Metric `{name}` ({type(metric).__name__}) accepts at most"
            f" {len(positional)} positional update argument(s) ({names}) but the"
            f" collection update was called with {len(args)}. Positional args are"
            " forwarded verbatim to every metric — pass per-metric inputs as"
            " keyword arguments (they are filtered against each metric's update"
            " signature), or drop the metric into its own collection."
        )


# --------------------------------------------------------- input splitting


def _split_inputs(
    args: Tuple, kwargs: Dict, device: Optional[torch.device] = None
) -> Tuple[List[Tensor], Tuple[Any, tuple]]:
    """Tensor leaves of ``(args, kwargs)`` (dynamic: copied into a graph's input
    buffers) and the spec of the rest (static: fixed in the graph, part of its key).
    With a ``device``, numpy arrays become tensors there and are dynamic too."""
    leaves, treedef = pytree.tree_flatten((args, dict(kwargs)))
    dyn: List[Tensor] = []
    spec: List[Any] = []
    for leaf in leaves:
        if device is not None and isinstance(leaf, np.ndarray):
            leaf = torch.as_tensor(leaf, device=device)
        if isinstance(leaf, Tensor):
            dyn.append(leaf)
            spec.append(_DYN)
        else:
            spec.append(leaf)
    return dyn, (treedef, tuple(spec))


def _merge_inputs(dyn: Sequence[Tensor], split_spec: Tuple[Any, tuple]) -> Tuple[Tuple, Dict]:
    treedef, spec = split_spec
    it = iter(dyn)
    args, kwargs = pytree.tree_unflatten([next(it) if s is _DYN else s for s in spec], treedef)
    return args, kwargs


def _static_key(spec: Tuple[Any, tuple]) -> Tuple:
    """Hashable key of the static leaves, by value (an exotic object by identity)."""
    treedef, leaves = spec
    parts = []
    for leaf in leaves:
        if leaf is _DYN:
            parts.append("dyn")
        elif isinstance(leaf, (bool, int, float, str, bytes, type(None))):
            parts.append((type(leaf).__name__, leaf))
        else:
            parts.append(("id", id(leaf)))
    return (treedef, tuple(parts))


def _tensor_key(tree: Any) -> Tuple:
    """Structure, shapes, dtypes and devices of a tree of dicts, lists and tuples of
    tensors (a direct walk: it is on every step's host path)."""
    if isinstance(tree, Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, _tensor_key(v)) for k, v in tree.items())
    return tuple(_tensor_key(v) for v in tree)


def _step_device(*trees: Any) -> Optional[torch.device]:
    for leaf in pytree.tree_leaves(trees):
        if isinstance(leaf, Tensor):
            return leaf.device
    return None


# ----------------------------------------------------------- graph capture


class CapturedStep:
    """A pure step ``step(states, *extras) -> (new_states, outputs)`` captured into
    one CUDA graph over static buffers.

    ``states`` is a tree of tensors whose new values the graph copies into the
    static state buffers at its end; ``extras`` are the step's tensor inputs, copied
    into static input buffers before each replay. ``outputs`` (None, or a tree of
    tensors) come back as copies. A capture raises where the step cannot be
    captured: a host read of device values, a new state of another shape or dtype
    than the old one.

    The kernel wrappers' ``launches`` (``_build.LAUNCH_COUNTERS``) count the warm-up's
    launches, which run; the capture's calls only record theirs, so what they added
    is taken back and added again at each replay.
    """

    def __init__(self, step: Callable, states: Any, extras: Sequence[Any], device: torch.device) -> None:
        state_leaves, self._state_spec = pytree.tree_flatten(states)
        extra_leaves, self._extra_spec = pytree.tree_flatten(list(extras))
        self._states = [t.clone() for t in state_leaves]
        for buf in self._states:
            buf._step_buffer = True  # the live state is this buffer after a replay
        self._extras = [t.clone() for t in extra_leaves]
        static_states = pytree.tree_unflatten(self._states, self._state_spec)
        static_extras = pytree.tree_unflatten(self._extras, self._extra_spec)
        with torch.cuda.device(device):
            # warm-up: the kernels' first launch does its one-time set-up outside the graph
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), tracing():
                step(static_states, *static_extras)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = [w.launches for w in _build.LAUNCH_COUNTERS]
            try:
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"), tracing():
                    new_states, outputs = step(static_states, *static_extras)
                    new_leaves, new_spec = pytree.tree_flatten(new_states)
                    if new_spec != self._state_spec:
                        raise RuntimeError("the step's new state has another structure than its state")
                    for old, new in zip(self._states, new_leaves):
                        if new.shape != old.shape or new.dtype != old.dtype:
                            raise RuntimeError(
                                f"the step turns a {old.dtype} state of shape {tuple(old.shape)} into a"
                                f" {new.dtype} one of shape {tuple(new.shape)}"
                            )
                        if new is not old:
                            old.copy_(new)
            finally:
                # (wrapper, launches recorded in the graph): none of them ran yet
                self._recorded = [
                    (w, w.launches - n) for w, n in zip(_build.LAUNCH_COUNTERS, before) if w.launches != n
                ]
                for wrapper, n in self._recorded:
                    wrapper.launches -= n
        self._outputs = outputs

    def __call__(self, states: Any, extras: Sequence[Any]) -> Tuple[Any, Any]:
        for buf, live in zip(self._states, pytree.tree_leaves(states)):
            if live is not buf:  # the live state left its buffer: copy it in once
                buf.copy_(live)
        for buf, live in zip(self._extras, pytree.tree_leaves(list(extras))):
            buf.copy_(live)
        self.graph.replay()
        for wrapper, n in self._recorded:
            wrapper.launches += n
        outputs = pytree.tree_map(lambda t: t.clone() if isinstance(t, Tensor) else t, self._outputs)
        return pytree.tree_unflatten(self._states, self._state_spec), outputs


def is_step_buffer(value: Any) -> bool:
    """Is ``value`` a captured step's static state buffer, which the step's next
    replay overwrites in place?"""
    return isinstance(value, Tensor) and getattr(value, "_step_buffer", False)


class _EagerStep:
    """The plain version of :class:`CapturedStep`: the step run eagerly on each call,
    with value checks skipped as in a captured graph."""

    def __init__(self, step: Callable) -> None:
        self._step = step

    def __call__(self, states: Any, extras: Sequence[Any]) -> Tuple[Any, Any]:
        with tracing():
            return self._step(states, *extras)


def compile_step(step: Callable, states: Any, extras: Sequence[Any]) -> Any:
    """The step as a :class:`CapturedStep` when its tensors are on a CUDA device,
    else as its eager plain version."""
    device = _step_device(states, extras)
    if device is not None and device.type == "cuda":
        return CapturedStep(step, states, extras, device)
    return _EagerStep(step)


class StepCache:
    """Compiled steps by key, shared by both engines (:class:`FusedCollectionUpdate`
    and ``core/fleet.py:run_step``).

    A key's first :meth:`call` compiles its step (:func:`compile_step`: a capture on
    a CUDA device) and runs it; later calls replay it. A key whose compile or call
    fails is broken for good: the failure counts in ``stats["degrades"]`` with a
    ``RuntimeWarning`` (one per site and error class), and :meth:`call` returns None
    for the key from then on, so that the caller runs its eager path. ``stats`` also
    counts ``launches`` (steps run compiled), ``cache_hits`` and ``cache_misses``.

    An armed fault schedule fires ``<site>.compile`` before a key's first compile and
    (for the fused site) ``fused.launch`` before each run; a fired fault breaks the
    key as a real failure does, even where ``raise_first`` would raise.
    """

    def __init__(self, site: str, stats: Optional[Dict[str, int]] = None) -> None:
        self.site = site
        self.steps: Dict[Tuple, Any] = {}
        self.broken: set = set()
        self.stats = {} if stats is None else stats
        for name in ("launches", "cache_hits", "cache_misses", "degrades"):
            self.stats.setdefault(name, 0)

    def call(
        self,
        key: Tuple,
        make_step: Callable[[], Callable],
        states: Any,
        extras: Sequence[Any],
        detail: str,
        raise_first: bool = False,
    ) -> Optional[Tuple[Any, Any]]:
        """``(new_states, outputs)`` of the key's step, compiled from ``make_step()``
        at the key's first call; None when the key is broken. With ``raise_first``,
        a failure of the key's first call raises and leaves the key unmarked."""
        if key in self.broken:
            return None
        compiled = self.steps.get(key)
        first = compiled is None
        self.stats["cache_misses" if first else "cache_hits"] += 1
        if _fault._SCHEDULE is not None:
            try:
                if first and f"{self.site}.compile" in _fault.SITES:
                    _fault.fire(f"{self.site}.compile", key=str(key[0]))
                if self.site == "fused":
                    _fault.fire("fused.launch", key=str(key[0]))
            except _fault.InjectedFaultError as err:
                self.broken.add(key)
                self.stats["degrades"] += 1
                _warn_degrade_once(f"{self.site}.{'compile' if first else 'launch'}", err, detail)
                return None
        try:
            if first:
                compiled = compile_step(make_step(), states, extras)
            out = compiled(states, extras)
        except Exception as err:  # noqa: BLE001 - the caller's eager path is always correct
            if first and raise_first:
                raise
            self.broken.add(key)
            self.stats["degrades"] += 1
            _warn_degrade_once(f"{self.site}.{'capture' if first else 'replay'}", err, detail)
            return None
        self.steps[key] = compiled
        self.stats["launches"] += 1
        return out


# ------------------------------------------------------------------ engine


class FusedCollectionUpdate:
    """Per-collection fused-update engine (see the module docstring).

    Held in a :class:`weakref.WeakKeyDictionary` keyed by the collection
    (:func:`engine_for`), so that the collection stays picklable and deep-copyable
    and its graphs die with it.
    """

    def __init__(self) -> None:
        self.stats: Dict[str, int] = {"fallback_groups": 0}
        # (mode, topology, state key, input key, static key) -> captured step
        self._steps = StepCache("fused", self.stats)
        # leaders whose own capture probe failed: eager for good
        self._trace_fallbacks: Dict[str, str] = {}

    # ---------------------------------------------------------- partition

    def _partition(
        self, collection: Any, forward: bool
    ) -> Tuple[List[Tuple[str, Tuple[str, ...]]], List[List[str]], Dict[str, str]]:
        """Split the collection's compute groups into fused and eager ones."""
        fused: List[Tuple[str, Tuple[str, ...]]] = []
        eager: List[List[str]] = []
        reasons: Dict[str, str] = {}
        device = None
        for cg in collection._groups.values():
            leader = collection._modules[cg[0]]
            reason = self._trace_fallbacks.get(cg[0]) or fusion_fallback_reason(
                leader, [collection._modules[n] for n in cg], forward=forward
            )
            if reason is None and leader._is_synced:
                # a metric inside sync_context views synced state: a temporary
                reason = "mid-sync_context (synced state is a temporary view)"
            if reason is None:
                device = device or leader.device
                if leader.device != device:
                    reason = f"on {leader.device}, while the fused step runs on {device}"
            if reason is None:
                fused.append((cg[0], tuple(cg)))
            else:
                eager.append(list(cg))
                reasons[cg[0]] = reason
        return fused, eager, reasons

    # ------------------------------------------------------------ probing

    def _probe(
        self,
        collection: Any,
        fused: List[Tuple[str, Tuple[str, ...]]],
        states: Dict[str, Any],
        dyn: List[Tensor],
        split_spec: Tuple[Any, tuple],
        forward: bool,
    ) -> Tuple[List[Tuple[str, Tuple[str, ...]]], List[List[str]]]:
        """Capture each candidate group alone (on the CPU: run it once) and demote
        the ones that fail, so that a failure is put down to its group. It runs only
        after the chained step's first capture failed; a demoted group stays eager
        for good (``_trace_fallbacks``)."""
        survivors: List[Tuple[str, Tuple[str, ...]]] = []
        demoted: List[List[str]] = []
        for name, members in fused:
            step = self._build(collection, [(name, members)], split_spec, forward)
            try:
                trial = compile_step(step, {name: states[name]}, [dyn])
                if isinstance(trial, _EagerStep):
                    trial({name: states[name]}, [dyn])
                del trial
            except Exception as err:  # noqa: BLE001 - a group that cannot fuse stays eager
                reason = f"capture failed: {type(err).__name__}: {str(err).splitlines()[0][:200] if str(err) else ''}"
                self._trace_fallbacks[name] = reason
                demoted.append(list(members))
                warnings.warn(
                    f"metrics_tpu_torch fused update: group led by `{name}`"
                    f" ({type(collection._modules[name]).__name__}) cannot fuse and stays eager — {reason}",
                    RuntimeWarning,
                    stacklevel=4,
                )
            else:
                survivors.append((name, members))
        return survivors, demoted

    def _build(
        self,
        collection: Any,
        fused: List[Tuple[str, Tuple[str, ...]]],
        split_spec: Tuple[Any, tuple],
        forward: bool,
    ) -> Callable:
        """The pure chained step over the fused groups: ``step(states, dyn) ->
        (new_states, member batch values)``."""
        bound = [
            (name, members, collection._modules[name], tuple(collection._modules[n] for n in members))
            for name, members in fused
        ]

        def step(states: Dict[str, Any], dyn_leaves: List[Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
            args, kwargs = _merge_inputs(dyn_leaves, split_spec)
            new_states: Dict[str, Any] = {}
            results: Dict[str, Any] = {}
            for name, members, leader, member_metrics in bound:
                filtered = leader._filter_kwargs(**kwargs)
                new_states[name] = leader.local_update(states[name], *args, **filtered)
                if forward:
                    batch = leader.local_update(leader.init_state(), *args, **filtered)
                    for member_name, member in zip(members, member_metrics):
                        results[member_name] = member.compute_from(batch)
            return new_states, results

        return step

    # ------------------------------------------------------------ stepping

    def _gather_states(self, collection: Any, fused: List[Tuple[str, Tuple[str, ...]]]) -> Dict[str, Any]:
        return {name: collection._modules[name].state_pytree() for name, _ in fused}

    def _launch(
        self, collection: Any, fused: List[Tuple[str, Tuple[str, ...]]], args: Tuple, kwargs: Dict, forward: bool
    ) -> Tuple[List[Tuple[str, Tuple[str, ...]]], List[List[str]], Dict[str, Any]]:
        """Capture or reuse, replay, re-point. Returns (the groups that ran fused,
        the demoted groups, the member batch values)."""
        dyn, split_spec = _split_inputs(args, kwargs, collection._modules[fused[0][0]].device)
        mode = "forward" if forward else "update"
        dyn_key = _tensor_key(dyn)

        def key_of(groups, states):
            topo = tuple((name, members, id(collection._modules[name])) for name, members in groups)
            return (mode, topo, _tensor_key(states), dyn_key, _static_key(split_spec))

        def run(groups, states, raise_first=False):
            return self._steps.call(
                key_of(groups, states),
                lambda: self._build(collection, groups, split_spec, forward),
                states,
                [dyn],
                "the group(s) run eagerly for this input signature from now on.",
                raise_first=raise_first,
            )

        states = self._gather_states(collection, fused)
        demoted: List[List[str]] = []
        try:
            out = run(fused, states, raise_first=True)
        except Exception:  # noqa: BLE001 - the chained step's first capture failed: find the groups at fault
            fused, demoted = self._probe(collection, fused, states, dyn, split_spec, forward)
            if not fused:
                return [], demoted, {}
            states = {name: states[name] for name, _ in fused}
            out = run(fused, states)
        if out is None:
            return [], demoted + [list(m) for _, m in fused], {}
        new_states, results = out
        for name, _ in fused:
            m = collection._modules[name]
            # the graph's state buffers; after the first replay of a key they are the
            # live states already, and nothing is re-pointed
            m._load_state({k: v for k, v in new_states[name].items() if getattr(m, k) is not v})
            m._update_count += 1
            m._computed = None
        return fused, demoted, results

    def update(self, collection: Any, *args: Any, **kwargs: Any) -> None:
        """One fused accumulation step, plus the eager groups."""
        fused, eager, _ = self._partition(collection, forward=False)
        for name, _members in fused:
            _check_update_arity(name, collection._modules[name], args)
        if fused:
            _launched, demoted, _ = self._launch(collection, fused, args, kwargs, forward=False)
            eager = eager + demoted
        if eager:
            self.stats["fallback_groups"] += len(eager)
            for cg in eager:
                m0 = collection._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
        collection._state_is_copy = False
        collection._compute_groups_create_state_ref()

    def forward(self, collection: Any, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """One fused step that accumulates and returns every member's batch value."""
        res: Dict[str, Any] = {}
        fused, eager, _ = self._partition(collection, forward=True)
        for name, _members in fused:
            _check_update_arity(name, collection._modules[name], args)
        if fused:
            launched, demoted, results = self._launch(collection, fused, args, kwargs, forward=True)
            eager = eager + demoted
            for _name, members in launched:
                for member_name in members:
                    mi = collection._modules[member_name]
                    val = _squeeze_if_scalar(results[member_name])
                    mi._forward_cache = val
                    mi._computed = None
                    res[member_name] = val
        if eager:
            self.stats["fallback_groups"] += len(eager)
            for cg in eager:
                for name in cg:
                    m = collection._modules[name]
                    res[name] = m(*args, **m._filter_kwargs(**kwargs))
        collection._state_is_copy = False
        collection._compute_groups_create_state_ref()
        return res


#: engines keyed weakly by collection: the collection stays free of graphs
#: (clone, deepcopy and pickle are untouched) and its graphs die with it
_ENGINES: "weakref.WeakKeyDictionary[Any, FusedCollectionUpdate]" = weakref.WeakKeyDictionary()


def engine_for(collection: Any) -> FusedCollectionUpdate:
    engine = _ENGINES.get(collection)
    if engine is None:
        engine = FusedCollectionUpdate()
        _ENGINES[collection] = engine
    return engine


# ------------------------------------------------- canonical fused collection


def _canonical_metrics(device: Any = None) -> List[Metric]:
    from metrics_tpu_torch.classification import BinaryAccuracy, BinaryAUROC, BinaryConfusionMatrix
    from metrics_tpu_torch.regression import MeanAbsoluteError, MeanSquaredError

    # five distinct update functions: five compute groups, five eager updates a step,
    # all on the same (preds, target) pair
    return [
        BinaryAccuracy(device=device),
        BinaryConfusionMatrix(device=device),
        BinaryAUROC(thresholds=11, device=device),
        MeanSquaredError(device=device),
        MeanAbsoluteError(device=device),
    ]


def canonical_collection(fused: bool = True, device: Any = None) -> Any:
    """The JAX package's canonical five-group fusable collection
    (``metrics_tpu/core/fused.py:852-870``)."""
    from metrics_tpu_torch.core.collections import MetricCollection

    return MetricCollection(_canonical_metrics(device), fused=fused)
