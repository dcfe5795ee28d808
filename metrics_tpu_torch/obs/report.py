"""Structured state reports for metrics and collections (counterpart of
``metrics_tpu/obs/report.py``).

``Metric.state_report()`` answers "what is this metric holding right now": one row
a registered state with dtype, shape, nbytes and the device it lives on, and for a
fixed-capacity ``CatBuffer`` state its fill against its capacity and the overflow
flag. ``MetricCollection.summary()`` adds the compute-group topology: which metrics
share state and the bytes the grouping saves.

Everything here is read on the host from shapes, dtypes and the ``CatBuffer``'s host
counts: no device value is read, so a report never waits for the card, also on a
state that a CUDA graph being captured holds.

Deviation from the JAX package: its ``sharding`` and ``layout`` columns describe an
``Array.sharding``, which has no torch meaning; they read None here, and the
``device`` column says where the bytes live.
"""
import sys
from typing import Any, Dict, List

import numpy as np

__all__ = ["collection_summary", "metric_state_report"]


def _dtype_name(dtype: Any) -> str:
    """``float32`` for ``torch.float32`` or ``np.float32``: the JAX package's form."""
    return str(dtype).replace("torch.", "")


def _nbytes(value: Any) -> int:
    if hasattr(value, "element_size") and hasattr(value, "numel"):
        return int(value.numel()) * int(value.element_size())
    arr = np.asarray(value)
    return int(arr.size) * arr.dtype.itemsize


def _shape(value: Any) -> tuple:
    return tuple(int(s) for s in getattr(value, "shape", np.shape(value)))


def _device(value: Any) -> Any:
    device = getattr(value, "device", None)
    return None if device is None else str(device)


def _state_entry(name: str, value: Any) -> Dict[str, Any]:
    from metrics_tpu_torch.core.state import CatBuffer

    if isinstance(value, CatBuffer):
        return {
            "name": name,
            "kind": "cat_buffer",
            "dtype": _dtype_name(value.data.dtype),
            "shape": _shape(value.data),
            "nbytes": _nbytes(value.data),
            "sharding": None,
            "layout": None,
            "device": _device(value.data),
            "capacity": value.capacity,
            "fill": int(value.valid_count()),
            "overflowed": bool(value.overflowed()),
        }
    if isinstance(value, (list, tuple)):
        return {
            "name": name,
            "kind": "list",
            "dtype": _dtype_name(getattr(value[0], "dtype", "?")) if value else None,
            "shape": [_shape(v) for v in value],
            "nbytes": sum(_nbytes(v) for v in value),
            "sharding": None,
            "layout": None,
            "device": _device(value[0]) if value else None,
            "length": len(value),
        }
    return {
        "name": name,
        "kind": "array",
        "dtype": _dtype_name(getattr(value, "dtype", np.asarray(value).dtype)),
        "shape": _shape(value),
        "nbytes": _nbytes(value),
        "sharding": None,
        "layout": None,
        "device": _device(value),
    }


def metric_state_report(metric: Any) -> Dict[str, Any]:
    """One metric's report: a row per state and the totals."""
    states: List[Dict[str, Any]] = [_state_entry(name, getattr(metric, name)) for name in metric._defaults]
    report = {
        "metric": type(metric).__name__,
        "update_count": metric._update_count,
        "states": states,
        "total_nbytes": int(sum(s["nbytes"] for s in states)),
    }
    fleet_size = getattr(metric, "fleet_size", None)
    if fleet_size is not None:
        report["fleet_size"] = int(fleet_size)
    ckpt_stats = getattr(metric, "_ckpt_stats", None)
    if isinstance(ckpt_stats, dict) and ckpt_stats:
        report["ckpt"] = dict(ckpt_stats)
    _attach_warmup(report)
    return report


def _attach_warmup(report: Dict[str, Any]) -> None:
    """The last prewarm's report, when the executable-cache module is in use."""
    _excache = sys.modules.get("metrics_tpu_torch.serve.excache")
    if _excache is not None:
        warmup = _excache.last_prewarm()
        if warmup is not None:
            report["warmup"] = warmup


def collection_summary(collection: Any) -> Dict[str, Any]:
    """A collection's report: each metric's report and the compute groups."""
    reports = {name: metric_state_report(m) for name, m in collection.items(keep_base=True, copy_state=False)}
    groups = []
    for members in getattr(collection, "_groups", {}).values():
        leader = members[0]
        # the members point at the leader's tensors: one group costs one leader
        groups.append({"leader": leader, "members": list(members), "shared_nbytes": reports[leader]["total_nbytes"]})
    naive = sum(r["total_nbytes"] for r in reports.values())
    shared = sum(g["shared_nbytes"] for g in groups) if groups else naive
    out = {
        "metrics": reports,
        "compute_groups": groups,
        "total_nbytes": shared,
        "nbytes_saved_by_groups": int(naive - shared),
    }
    ckpt_stats = getattr(collection, "_ckpt_stats", None)
    if isinstance(ckpt_stats, dict) and ckpt_stats:
        out["ckpt"] = dict(ckpt_stats)
    if getattr(collection, "fused", False):
        from metrics_tpu_torch.core.fused import _ENGINES

        engine = _ENGINES.get(collection)
        out["fused"] = dict(engine.stats) if engine is not None else {"launches": 0}
    _attach_warmup(out)
    return out
