"""Manifest schema: the host-side description of a metric's state tree
(counterpart of ``metrics_tpu/ckpt/manifest.py``, same keys and values).

A manifest is the JSON half of a checkpoint: per state its kind, dtype, shape,
reduction and (for a ``CatBuffer``) item shape, the child metrics, the fleet size
and the update counts; the payload holds the bytes. Restore validates the manifest
against the live tree **before** it touches any state, raising the typed errors of
:mod:`~metrics_tpu_torch.ckpt.errors`, so a failed restore never leaves a metric
half-loaded.

Dtypes are written under numpy's names (``float32``, ``int64``, ``bool``,
``bfloat16``), as the JAX package writes them, so that a checkpoint of one package
validates against the other wherever the states' dtypes agree.

Child metrics are found by value: a wrapper's ``Metric`` submodules, and lists
(``nn.ModuleList``) of them, keyed by attribute name, serialized as nested trees.
A callable reduction is recorded by its qualified name, which names its package:
such a state does not cross between the two packages.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from metrics_tpu_torch.ckpt.errors import DtypeDriftError, SchemaDriftError, ShapeDriftError

FORMAT = "metrics_tpu.ckpt"
FORMAT_VERSION = 1

#: state-kind tags used in manifests
KIND_ARRAY = "array"
KIND_CAT_BUFFER = "cat_buffer"
KIND_LIST = "list"


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.float32`` -> ``"float32"``); the JAX
    package writes ``str(array.dtype)``, which is the same string."""
    return str(dtype).replace("torch.", "")


def reduce_spec(fx: Union[str, Callable, None]) -> Optional[str]:
    """JSON-stable name of a ``dist_reduce_fx``: strings as they are, None as null,
    a callable by its qualified name."""
    if fx is None or isinstance(fx, str):
        return fx
    return f"callable:{getattr(fx, '__module__', '?')}.{getattr(fx, '__qualname__', repr(fx))}"


def child_metrics(metric: Any) -> Dict[str, Union[Any, List[Any]]]:
    """The ``Metric`` instances held by ``metric``: ``{attr: Metric}`` and
    ``{attr: [Metric, ...]}`` in sorted attribute order, from its submodules and its
    plain attributes; registered states never count."""
    from metrics_tpu_torch.core.metric import Metric

    found: Dict[str, Any] = {}
    for attr, value in list(vars(metric).items()) + list(metric._modules.items()):
        if attr in getattr(metric, "_defaults", {}) or attr.startswith("__"):
            continue
        if isinstance(value, Metric):
            found[attr] = value
        elif isinstance(value, (list, tuple, torch.nn.ModuleList)) and len(value) > 0:
            items = list(value)
            if all(isinstance(v, Metric) for v in items):
                found[attr] = items
    return {attr: found[attr] for attr in sorted(found)}


def _value_kind(value: Any) -> str:
    from metrics_tpu_torch.core.state import CatBuffer

    if isinstance(value, CatBuffer):
        return KIND_CAT_BUFFER
    if isinstance(value, (list, tuple)):
        return KIND_LIST
    return KIND_ARRAY


def _default_spec(default: Any) -> Dict[str, Any]:
    """Validation descriptor of a state's registered default (its reset value):
    defaults encode the configuration, live values are data (a state reshaped on
    the first update is no drift)."""
    from metrics_tpu_torch.core.state import CatBuffer

    if isinstance(default, CatBuffer):
        return {
            "kind": KIND_CAT_BUFFER,
            "dtype": dtype_name(default.data.dtype),
            "item_shape": list(default.data.shape[1:]),
        }
    if isinstance(default, (list, tuple)):
        return {"kind": KIND_LIST}
    return {
        "kind": KIND_ARRAY,
        "dtype": dtype_name(default.dtype) if isinstance(default, torch.Tensor) else str(getattr(default, "dtype", None)),
        "shape": list(getattr(default, "shape", ())),
    }


def state_spec(metric: Any, name: str) -> Dict[str, Any]:
    """Manifest entry of one registered state: ``kind`` of the current value (it keys
    the payload entries), ``default`` the descriptor restore validates."""
    return {
        "reduce": reduce_spec(metric._reductions.get(name)),
        "kind": _value_kind(getattr(metric, name)),
        "default": _default_spec(metric._defaults[name]),
    }


def metric_schema(metric: Any, persistent_only: bool = False) -> Dict[str, Any]:
    """Schema of a metric: its states and its child metrics' trees."""
    states = {
        name: state_spec(metric, name)
        for name in metric._defaults
        if not persistent_only or metric._persistent.get(name, False)
    }
    children: Dict[str, Any] = {}
    for attr, child in child_metrics(metric).items():
        if isinstance(child, list):
            children[attr] = [metric_schema(c, persistent_only) for c in child]
        else:
            children[attr] = metric_schema(child, persistent_only)
    out = {
        "class": type(metric).__name__,
        "update_count": int(metric._update_count),
        "states": states,
        "children": children,
    }
    fleet_size = getattr(metric, "fleet_size", None)
    if fleet_size is not None:
        # fleet states are shaped (fleet_size, *base): recorded so that restore can
        # name fleet drift and slice one stream out (restore_checkpoint(..., stream=i))
        out["fleet_size"] = int(fleet_size)
    return out


def _drift(path: str, what: str) -> str:
    return f"checkpoint schema drift at `{path or '<root>'}`: {what}"


def validate_schema(live: Dict[str, Any], saved: Dict[str, Any], path: str = "", allow_subset: bool = False) -> None:
    """Raise a typed error where ``saved`` cannot load into ``live``.

    ``allow_subset`` lets the saved states and children be a subset of the live ones
    (``persistent_only`` saves); extra saved entries always fail. ``CatBuffer``
    capacities are not compared: restore packs rows into the live capacity.
    """
    if live["class"] != saved["class"]:
        raise SchemaDriftError(_drift(path, f"saved metric class {saved['class']!r} != live {live['class']!r}"))
    live_fleet, saved_fleet = live.get("fleet_size"), saved.get("fleet_size")
    if live_fleet != saved_fleet:
        raise ShapeDriftError(
            _drift(
                path,
                f"saved fleet axis fleet_size={saved_fleet} != live fleet_size={live_fleet}:"
                " every fleet state is shaped (fleet_size, *base). Restore into a metric of"
                " the saved fleet_size, or slice one stream with"
                " restore_checkpoint(..., stream=i)",
            )
        )
    live_states, saved_states = live["states"], saved["states"]
    missing = sorted(set(saved_states) - set(live_states))
    if missing:
        raise SchemaDriftError(_drift(path, f"saved states {missing} do not exist on the live metric"))
    if not allow_subset:
        extra = sorted(set(live_states) - set(saved_states))
        if extra:
            raise SchemaDriftError(_drift(path, f"live states {extra} are missing from the checkpoint"))
    for name in saved_states:
        ls, ss = live_states[name], saved_states[name]
        spath = f"{path}.{name}" if path else name
        if ls["reduce"] != ss["reduce"]:
            raise SchemaDriftError(_drift(spath, f"saved reduce {ss['reduce']!r} != live reduce {ls['reduce']!r}"))
        ld, sd = ls["default"], ss["default"]
        if ld["kind"] != sd["kind"]:
            raise SchemaDriftError(_drift(spath, f"saved kind {sd['kind']!r} != live kind {ld['kind']!r}"))
        if sd["kind"] in (KIND_ARRAY, KIND_CAT_BUFFER) and ld["dtype"] != sd["dtype"]:
            raise DtypeDriftError(_drift(spath, f"saved dtype {sd['dtype']} != live dtype {ld['dtype']}"))
        if sd["kind"] == KIND_ARRAY and list(ld["shape"]) != list(sd["shape"]):
            raise ShapeDriftError(_drift(spath, f"saved shape {sd['shape']} != live shape {ld['shape']}"))
        if sd["kind"] == KIND_CAT_BUFFER and list(ld["item_shape"]) != list(sd["item_shape"]):
            raise ShapeDriftError(
                _drift(spath, f"saved item shape {sd['item_shape']} != live item shape {ld['item_shape']}")
            )
    live_children, saved_children = live["children"], saved["children"]
    missing_c = sorted(set(saved_children) - set(live_children))
    if missing_c:
        raise SchemaDriftError(_drift(path, f"saved child metrics {missing_c} do not exist live"))
    if not allow_subset:
        extra_c = sorted(set(live_children) - set(saved_children))
        if extra_c:
            raise SchemaDriftError(_drift(path, f"live child metrics {extra_c} missing from checkpoint"))
    for attr in saved_children:
        lc, sc = live_children[attr], saved_children[attr]
        cpath = f"{path}.{attr}" if path else attr
        if isinstance(sc, list) != isinstance(lc, list):
            raise SchemaDriftError(_drift(cpath, "child metric list/single mismatch"))
        if isinstance(sc, list):
            if len(sc) != len(lc):
                raise SchemaDriftError(_drift(cpath, f"saved {len(sc)} child metrics != live {len(lc)}"))
            for i, (l_i, s_i) in enumerate(zip(lc, sc)):
                validate_schema(l_i, s_i, f"{cpath}[{i}]", allow_subset)
        else:
            validate_schema(lc, sc, cpath, allow_subset)


def collection_groups(collection: Any) -> List[List[str]]:
    """A collection's compute groups as name lists (leader first); a collection
    without groups gets one group a metric."""
    groups = [list(v) for v in getattr(collection, "_groups", {}).values()]
    if not groups:
        groups = [[str(k)] for k in collection._modules]
    return groups
