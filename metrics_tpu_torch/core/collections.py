"""MetricCollection: metrics that share one ``update`` call, with compute groups
(counterpart of ``metrics_tpu/core/collections.py``).

In PyTorch's idiom the collection is an ``nn.ModuleDict`` of its metrics, so
``.to()``, ``state_dict`` and ``load_state_dict`` come from ``nn.Module`` (keys
``"<name>.<state>"``, as the JAX package writes them).

Compute groups form statically when the collection is built, as in the JAX
package: two metrics share a group iff they run the same ``update`` function over
the same state schema with the same update-relevant constructor arguments (a
family's ``_update_signature_attrs``, else every constructor attribute that is not
a runtime knob), on the same device, and neither has been updated yet. Only each
group's leader updates; the other members point at the leader's state tensors.
Updates rebind their states (``self.confmat = self.confmat + ...``), so members
are re-pointed at the leader's state after every update, and a member whose state
was rebound elsewhere (a direct update or ``reset``) leaves its group. ``items``,
``values`` and ``[]`` hand out copies of the shared state unless
``copy_state=False``.

``fused=True`` routes ``update`` and ``forward`` through the fused engine
(:mod:`~metrics_tpu_torch.core.fused`): one CUDA-graph replay a step for every
group that can fuse. The pure tier (``init_state``, ``local_update``,
``sync_state``, ``compute_from``) carries one state dict per metric, keyed by name.

``save_checkpoint`` / ``restore_checkpoint`` go through
:mod:`~metrics_tpu_torch.ckpt`: each compute group's state is saved once, from its
leader (a fused leader's captured step buffers), and restore aliases the members to
their leader again; a fused collection's next replay copies the restored states into
its buffers. Not ported: ``plot`` raises ``NotImplementedError``.

With obs on, ``update``, ``forward`` and ``compute`` run in ``tm.collection.update``,
``tm.collection.forward`` and ``tm.collection.compute`` ranges
(:mod:`~metrics_tpu_torch.obs.scopes`).
"""
import os
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric, _squeeze_if_scalar
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.obs import scopes as _obs_scopes
from metrics_tpu_torch.utils.data import _flatten_dict, _same_device, allclose
from metrics_tpu_torch.utils.prints import rank_zero_warn


class MetricCollection(nn.ModuleDict):
    """Collection of metrics updated and computed as one.

    Args:
        metrics: a metric, a sequence of metrics (named by class) or a dict of
            them; nested collections are flattened into this one.
        additional_metrics: more metrics, with a sequence.
        prefix / postfix: added to every name in the results.
        compute_groups: True to derive the groups, False for none, or a list of
            lists of names.
        fused: run ``update`` and ``forward`` as one captured step for every group
            that can fuse (:class:`~metrics_tpu_torch.core.fused.FusedCollectionUpdate`).
    """

    _groups: Dict[int, List[str]]

    _GROUP_IRRELEVANT_ATTRS = frozenset(
        {
            # runtime and sync knobs: they never change the update's state transition
            "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn",
            "distributed_available_fn", "sync_on_compute", "validate_args", "training",
        }
    )

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        fused: bool = False,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        if not isinstance(fused, bool):
            raise ValueError(f"Expected keyword argument `fused` to be a `bool` but got {fused}")
        self.fused = fused
        self._groups = {}
        self._groups_checked = False
        self._state_is_copy = False
        self._in_add_metrics = False
        self._validate_groups_runtime = os.environ.get("METRICS_TPU_VALIDATE_COMPUTE_GROUPS", "") not in ("", "0")
        self._groups_validated = False

        self.add_metrics(metrics, *additional_metrics)

    # --------------------------------------------------------------- dict-like

    def __setitem__(self, key: str, value: Metric) -> None:
        self.add_module(key, value)
        # a metric added after the groups formed gets a group (its own, or one it
        # joins when fresh): the leader-only update would never reach it otherwise
        if self._groups_checked and not self._in_add_metrics:
            self._init_compute_groups()

    def __iter__(self):
        return iter(self.keys())

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules[key]

    # ------------------------------------------------------------------- flow

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Forward every metric and return the renamed batch values.

        With compute groups only each leader accumulates; every member's batch
        value is its compute over the one batch-only state the leader made.
        """
        if _obs._ENABLED:
            with _obs_scopes.annotate("tm.collection.forward"):
                return self._forward_impl(*args, **kwargs)
        return self._forward_impl(*args, **kwargs)

    def _forward_impl(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        if self._groups_checked and not (self._validate_groups_runtime and not self._groups_validated):
            res = self._forward_grouped(*args, **kwargs)
        else:
            res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def _forward_grouped(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """One update of each leader on the batch alone and one on its global state;
        groups with a ``dist_sync_on_step`` member forward each member (and split)."""
        self._split_diverged_members()
        if self.fused:
            from metrics_tpu_torch.core.fused import engine_for

            return engine_for(self).forward(self, *args, **kwargs)
        res: Dict[str, Any] = {}
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            if len(cg) == 1 or any(self._modules[n].dist_sync_on_step for n in cg):
                for name in cg:
                    m = self._modules[name]
                    res[name] = m(*args, **m._filter_kwargs(**kwargs))
                continue
            filtered = m0._filter_kwargs(**kwargs)
            batch_state = _batch_state(m0, *args, **filtered)
            m0.update(*args, **filtered)
            for name in cg:
                mi = self._modules[name]
                val = _compute_on(mi, batch_state)
                mi._forward_cache = val
                mi._computed = None
                res[name] = val
        self._state_is_copy = False
        self._compute_groups_create_state_ref()
        return res

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each metric; with compute groups, only each group's leader."""
        if _obs._ENABLED:
            with _obs_scopes.annotate("tm.collection.update"):
                self._update_impl(*args, **kwargs)
            return
        self._update_impl(*args, **kwargs)

    def _update_impl(self, *args: Any, **kwargs: Any) -> None:
        if self._groups_checked:
            if self._validate_groups_runtime and not self._groups_validated:
                self._validate_groups_against_runtime(*args, **kwargs)
                return
            self._split_diverged_members()
            if self.fused:
                from metrics_tpu_torch.core.fused import engine_for

                engine_for(self).update(self, *args, **kwargs)
                return
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
            self._state_is_copy = False
            self._compute_groups_create_state_ref()
        else:
            for _, m in self.items(keep_base=True, copy_state=False):
                m.update(*args, **m._filter_kwargs(**kwargs))

    def _split_diverged_members(self) -> None:
        """Give a member its own group when its state no longer is the leader's.

        A direct ``mc['name'].update(...)`` or ``reset()`` between collection updates
        rebinds that member's states; re-pointing it at the leader would drop what
        it holds. Skipped while members hold access copies (``_state_is_copy``).
        """
        if self._state_is_copy:
            return
        new_groups: List[List[str]] = []
        for cg in self._groups.values():
            kept = [cg[0]]
            m0 = self._modules[cg[0]]
            for name in cg[1:]:
                mi = self._modules[name]
                diverged = mi._update_count != m0._update_count or any(
                    getattr(mi, s) is not getattr(m0, s) for s in m0._defaults
                )
                if diverged:
                    new_groups.append([name])
                else:
                    kept.append(name)
            new_groups.append(kept)
        if len(new_groups) != len(self._groups):
            self._groups = dict(enumerate(new_groups))

    # ------------------------------------------------- static compute groups

    def _static_merge_groups(self) -> None:
        """Merge groups whose leaders have the same update signature (host only, no
        device reads)."""
        keys = list(self._groups)
        for i, k1 in enumerate(keys):
            if k1 not in self._groups:
                continue
            for k2 in keys[i + 1:]:
                if k2 not in self._groups:
                    continue
                m1 = self._modules[self._groups[k1][0]]
                m2 = self._modules[self._groups[k2][0]]
                if self._same_update_signature(m1, m2):
                    self._groups[k1].extend(self._groups.pop(k2))
        self._groups = dict(enumerate(self._groups.values()))

    @classmethod
    def _same_update_signature(cls, m1: Metric, m2: Metric) -> bool:
        # members share state by reference, so only fresh metrics may merge; and
        # states on two devices can never be one
        if m1._update_count != 0 or m2._update_count != 0:
            return False
        if not _same_device(m1.device, m2.device):
            return False
        upd1 = cls._update_owner(type(m1))
        upd2 = cls._update_owner(type(m2))
        if upd1 is None or upd1[1] is not upd2[1]:
            return False
        if not cls._same_state_schema(m1, m2):
            return False
        declared = cls._declared_signature_attrs(type(m1), upd1[0])
        if declared is not None and declared == cls._declared_signature_attrs(type(m2), upd2[0]):
            names1 = declared
        else:
            names1 = cls._fallback_signature_attrs(m1)
            if names1 != cls._fallback_signature_attrs(m2):
                return False
        return all(cls._attr_equal(getattr(m1, name, None), getattr(m2, name, None)) for name in names1)

    @staticmethod
    def _update_owner(klass: type) -> Optional[Tuple[type, Any]]:
        """(defining class, function) of ``update``, walking the MRO."""
        for c in klass.__mro__:
            if "update" in c.__dict__:
                return c, c.__dict__["update"]
        return None

    @staticmethod
    def _declared_signature_attrs(klass: type, update_owner: type) -> Optional[Tuple[str, ...]]:
        """A ``_update_signature_attrs`` declaration, valid only from the class that
        defines ``update`` or a subclass of it."""
        for c in klass.__mro__:
            if "_update_signature_attrs" in c.__dict__:
                decl = c.__dict__["_update_signature_attrs"]
                if decl is None:
                    return None
                return decl if issubclass(c, update_owner) else None
        return None

    @classmethod
    def _fallback_signature_attrs(cls, m: Metric) -> Tuple[str, ...]:
        # the wrapped update/compute are per-instance closures: never equal
        return tuple(
            sorted(
                k
                for k in vars(m)
                if not k.startswith("_")
                and k not in ("update", "compute")
                and k not in m._defaults
                and k not in cls._GROUP_IRRELEVANT_ATTRS
            )
        )

    @staticmethod
    def _same_state_schema(m1: Metric, m2: Metric) -> bool:
        if len(m1._defaults) == 0 or m1._defaults.keys() != m2._defaults.keys():
            return False
        for key in m1._defaults:
            d1, d2 = m1._defaults[key], m2._defaults[key]
            if type(d1) != type(d2):
                return False
            if isinstance(d1, CatBuffer):
                d1, d2 = d1.data, d2.data
            if isinstance(d1, Tensor) and (d1.shape != d2.shape or d1.dtype != d2.dtype):
                return False
            r1, r2 = m1._reductions.get(key), m2._reductions.get(key)
            if r1 is not r2 and r1 != r2:
                return False
            if m1._cat_meta.get(key) != m2._cat_meta.get(key):
                return False
        return True

    @classmethod
    def _attr_equal(cls, a: Any, b: Any) -> bool:
        if a is b:
            return True
        if type(a) != type(b):
            return False
        if isinstance(a, Tensor):
            return a.shape == b.shape and a.device == b.device and bool(torch.equal(a, b))
        if isinstance(a, np.ndarray):
            return a.shape == b.shape and bool(np.array_equal(a, b))
        if callable(a):
            return False  # identity already failed
        if isinstance(a, (list, tuple)):
            # element by element: ``==`` on metrics builds a (truthy) metric
            return len(a) == len(b) and all(cls._attr_equal(x, y) for x, y in zip(a, b))
        try:
            return bool(a == b)
        except (TypeError, ValueError, RuntimeError):  # incomparable values split, never crash
            return False

    def _validate_groups_against_runtime(self, *args: Any, **kwargs: Any) -> None:
        """Debug path (``METRICS_TPU_VALIDATE_COMPUTE_GROUPS=1``): update every metric
        once, merge by state equality as the reference does, warn where that
        differs from the static groups, and keep the static groups."""
        for _, m in self.items(keep_base=True, copy_state=False):
            m.update(*args, **m._filter_kwargs(**kwargs))
        static_groups = {i: list(v) for i, v in self._groups.items()}
        self._groups = {i: [str(k)] for i, k in enumerate(self._modules.keys())}
        self._runtime_merge_compute_groups()
        runtime_partition = {frozenset(v) for v in self._groups.values()}
        static_partition = {frozenset(v) for v in static_groups.values()}
        if runtime_partition != static_partition:
            rank_zero_warn(
                "Static compute groups disagree with the runtime state comparison:"
                f" static={sorted(map(sorted, static_partition))} vs"
                f" runtime={sorted(map(sorted, runtime_partition))}. The static"
                " derivation only ever splits where the states could differ."
            )
        self._groups = static_groups
        self._groups_validated = True
        self._state_is_copy = False
        self._compute_groups_create_state_ref()

    def _runtime_merge_compute_groups(self) -> None:
        """The reference's merge of groups whose leaders hold equal states."""
        n_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                merged = False
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    metric1 = self._modules[cg_members1[0]]
                    metric2 = self._modules[cg_members2[0]]
                    if self._equal_metric_states(metric1, metric2):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        merged = True
                        break
                if merged:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)
        self._groups = dict(enumerate(self._groups.values()))

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1 = getattr(metric1, key)
            state2 = getattr(metric2, key)
            if type(state1) != type(state2):
                return False
            if isinstance(state1, CatBuffer):
                state1, state2 = state1.values(), state2.values()
            if isinstance(state1, Tensor):
                if not allclose(state1, state2):
                    return False
            elif isinstance(state1, list):
                if len(state1) != len(state2) or not all(allclose(s1, s2) for s1, s2 in zip(state1, state2)):
                    return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Point every member's states at its leader's (copies of them with ``copy``)."""
        if not self._state_is_copy:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for i in range(1, len(cg)):
                    mi = self._modules[cg[i]]
                    for state in m0._defaults:
                        m0_state = getattr(m0, state)
                        setattr(mi, state, deepcopy(m0_state) if copy else m0_state)
                    if mi._update_count != m0._update_count:
                        # the leader's state moved on: a value the member cached is stale
                        # (the JAX package keeps serving it; a listed deviation)
                        mi._computed = None
                    mi._update_count = m0._update_count
        self._state_is_copy = copy

    def compute(self) -> Dict[str, Any]:
        """Every metric's value (each syncs across processes first), renamed."""
        if _obs._ENABLED:
            with _obs_scopes.annotate("tm.collection.compute"):
                res = {k: m.compute() for k, m in self.items(keep_base=True, copy_state=False)}
        else:
            res = {k: m.compute() for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    # ------------------------------------------------------- pure-functional tier

    def summary(self) -> Dict[str, Any]:
        """Each member's :meth:`Metric.state_report`, the compute groups and the bytes
        the grouping saves (render with
        :func:`~metrics_tpu_torch.utils.prints.render_collection_summary`)."""
        from metrics_tpu_torch.obs.report import collection_summary

        return collection_summary(self)

    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """Each metric's fresh state dict, keyed by its name in the collection. Each
        metric owns its state here: compute groups share nothing in the pure tier."""
        return {k: m.init_state() for k, m in self.items(keep_base=True, copy_state=False)}

    def local_update(self, state: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure state transition of every metric. Keyword arguments are filtered per
        metric, positional ones go to all: a metric that cannot take them raises a
        :class:`MetricsUserError` naming it."""
        from metrics_tpu_torch.core.fused import _check_update_arity

        for k, m in self.items(keep_base=True, copy_state=False):
            _check_update_arity(k, m, args)
        return {
            k: m.local_update(state[k], *args, **m._filter_kwargs(**kwargs))
            for k, m in self.items(keep_base=True, copy_state=False)
        }

    def sync_state(self, state: Dict[str, Dict[str, Any]], group: Optional[Any] = None) -> Dict[str, Dict[str, Any]]:
        """Every metric's state dict reduced over the process ``group`` (identity for None)."""
        return {k: m.sync_state(state[k], group) for k, m in self.items(keep_base=True, copy_state=False)}

    def compute_from(self, state: Dict[str, Dict[str, Any]], group: Optional[Any] = None) -> Dict[str, Any]:
        """The renamed result dict computed from a state of :meth:`local_update`."""
        res = {k: m.compute_from(state[k], group) for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def reset(self) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.persistent(mode)

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> Any:
        """``nn.Module.load_state_dict``, then every member points at its leader's
        loaded state again."""
        result = super().load_state_dict(state_dict, strict=strict)
        self._repoint()
        return result

    def _apply(self, fn: Any, *args: Any, **kwargs: Any) -> "MetricCollection":
        """``.to()`` and kin move each member on its own; share the leaders' states again."""
        super()._apply(fn, *args, **kwargs)
        self._repoint()
        return self

    def _repoint(self) -> None:
        if self._groups_checked:
            self._state_is_copy = False
            self._compute_groups_create_state_ref()

    def save_checkpoint(self, directory: str, step: Optional[int] = None, **kwargs: Any) -> Any:
        """Durable, atomic checkpoint of every member's state, each compute group's once
        (see :func:`metrics_tpu_torch.ckpt.save_checkpoint`)."""
        from metrics_tpu_torch.ckpt import save_checkpoint

        return save_checkpoint(self, directory, step=step, **kwargs)

    def restore_checkpoint(self, directory: str, step: Optional[int] = None, **kwargs: Any) -> int:
        """Restore a checkpoint of :meth:`save_checkpoint`, members re-aliased to their
        leaders (see :func:`metrics_tpu_torch.ckpt.restore_checkpoint`)."""
        from metrics_tpu_torch.ckpt import restore_checkpoint

        return restore_checkpoint(self, directory, step=step, **kwargs)

    def plot(self, val: Any = None, ax: Any = None, together: bool = False) -> Any:
        raise NotImplementedError("MetricCollection.plot is not ported")

    # ------------------------------------------------------------------ admin

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics (nested collections flattened) and derive the groups again."""
        self._in_add_metrics = True
        try:
            self._add_metrics_impl(metrics, *additional_metrics)
        finally:
            self._in_add_metrics = False

    def _add_metrics_impl(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, (Metric, MetricCollection)) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _init_compute_groups(self) -> None:
        """The groups: an explicit list (members it leaves out get groups of their
        own), or the static merge."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(list(v) for v in self._enable_compute_groups))
            covered = set()
            for v in self._groups.values():
                for metric in v:
                    if metric not in self:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                            f" Please make sure that {self._enable_compute_groups} matches {self.keys(keep_base=True)}"
                        )
                    covered.add(metric)
            for key in self._modules:
                if key not in covered:
                    self._groups[len(self._groups)] = [str(key)]
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._modules.keys())}
            self._static_merge_groups()
            self._groups_checked = True
            self._groups_validated = False
            self._compute_groups_create_state_ref()

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> "OrderedDict[str, Metric]":
        return OrderedDict((self._set_name(k), v) for k, v in self._modules.items())

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for k, v in self._modules.items():
            repr_str += f"\n  {k}: {v.__class__.__name__}"
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)"


def _batch_state(metric: Metric, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """``metric``'s states after an update on this batch alone; its own states and
    update count are left as they were."""
    global_state = {attr: getattr(metric, attr) for attr in metric._defaults}
    update_count = metric._update_count
    metric.reset()
    metric.update(*args, **kwargs)
    batch = {attr: getattr(metric, attr) for attr in metric._defaults}
    for attr, value in global_state.items():
        setattr(metric, attr, value)
    metric._update_count = update_count
    metric._computed = None
    return batch


def _compute_on(metric: Metric, state: Dict[str, Any]) -> Any:
    """``metric``'s value on ``state``, without syncing or caching; its own states
    are left as they were."""
    own = {attr: getattr(metric, attr) for attr in metric._defaults}
    for attr, value in state.items():
        setattr(metric, attr, value)
    try:
        return _squeeze_if_scalar(type(metric).compute(metric))
    finally:
        for attr, value in own.items():
            setattr(metric, attr, value)
