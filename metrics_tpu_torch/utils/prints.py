"""Rank-zero-only warnings and prints (counterpart of ``metrics_tpu/utils/prints.py``).

The rank is ``torch.distributed``'s when a process group is initialised, else 0.
"""
import warnings
from functools import wraps
from typing import Any, Callable

import torch


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    warnings.warn(message, *args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    print(*args, **kwargs)


def _human_bytes(n: int) -> str:
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if size < 1024 or unit == "GiB":
            return f"{size:.1f} {unit}" if unit != "B" else f"{int(size)} B"
        size /= 1024
    return f"{int(n)} B"


def render_state_report(report: dict) -> str:
    """A table of ``Metric.state_report()``: a row a state with its dtype, shape,
    bytes, device and, for a ``CatBuffer``, fill/capacity (and an overflow marker)."""
    rows = [("state", "dtype", "shape", "nbytes", "device", "fill")]
    for s in report["states"]:
        if s["kind"] == "cat_buffer":
            fill = "?" if s["fill"] is None else f"{s['fill']}/{s['capacity']}"
            if s.get("overflowed"):
                fill += " OVERFLOWED"
        elif s["kind"] == "list":
            fill = f"len={s['length']}"
        else:
            fill = "-"
        rows.append(
            (s["name"], str(s["dtype"]), str(s["shape"]), _human_bytes(s["nbytes"]), str(s.get("device") or "-"), fill)
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = [f"{report['metric']} (updates={report['update_count']}, total={_human_bytes(report['total_nbytes'])})"]
    for i, r in enumerate(rows):
        lines.append("  " + "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  " + "-" * (sum(widths) + 2 * (len(widths) - 1)))
    return "\n".join(lines)


def render_collection_summary(summary: dict) -> str:
    """``MetricCollection.summary()`` as text: each member's table, the compute groups
    and the bytes the grouping saves."""
    lines = [render_state_report(report) for report in summary["metrics"].values()]
    if summary["compute_groups"]:
        lines.append("compute groups:")
        for g in summary["compute_groups"]:
            members = ", ".join(g["members"])
            lines.append(f"  [{members}] <- leader {g['leader']} ({_human_bytes(g['shared_nbytes'])} shared)")
    lines.append(
        f"total: {_human_bytes(summary['total_nbytes'])} (groups save {_human_bytes(summary['nbytes_saved_by_groups'])})"
    )
    return "\n".join(lines)


def _root_class_shim(cls: type, name: str, domain: str, module: str) -> type:
    """A subclass of ``cls`` whose ``__init__`` warns (``FutureWarning``) that a domain
    metric built from the package root moved to its subpackage.

    ``module`` is the ``__name__`` of the defining ``_deprecated`` module, which binds
    the shim as ``_<name>`` so that pickled instances load again.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        warnings.warn(
            f"Importing `{name}` from `metrics_tpu_torch` was deprecated and will be removed in 2.0."
            f" Import `{name}` from `metrics_tpu_torch.{domain}` instead.",
            FutureWarning,
            stacklevel=2,
        )
        cls.__init__(self, *args, **kwargs)

    shim = type(f"_{name}", (cls,), {"__init__": __init__, "__module__": module, "__doc__": cls.__doc__})
    shim.__qualname__ = f"_{name}"
    return shim


def _root_func_shim(fn: Callable, name: str, domain: str) -> Callable:
    """``fn`` wrapped to warn (``FutureWarning``) on the root-functional call path."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        warnings.warn(
            f"Importing `{name}` from `metrics_tpu_torch.functional` was deprecated and will be removed in 2.0."
            f" Import `{name}` from `metrics_tpu_torch.functional.{domain}` instead.",
            FutureWarning,
            stacklevel=2,
        )
        return fn(*args, **kwargs)

    return wrapped
