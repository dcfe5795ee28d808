"""Abstract input model: the update arguments of each budgeted class, as fake tensors.

Counterpart of ``metrics_tpu/analysis/san/abstract_inputs.py``. tmsan traces metric
state transitions without materializing data: each budgeted class gets its
:class:`TraceCase`\\ s at the batch sizes in :data:`SIZES`, and the runner makes each
case's arguments into fake tensors (``FakeTensorMode.from_tensor``) on the trace's
device. The cases come from one table, ``obs/canon.py:budget_cases`` (the classes the
launch budget and the card tier walk, with their constructors and inputs), so that
the three tiers trace the same inputs. The cost budget (``costs.py``) is recorded at
the ``canon`` size only.

Resolution order for a class that is not in the table (a wrapped metric, a seeded
fixture): the ``Metric._san_input_specs(n)`` hook, then ``canon.PER_NAME``, then the
task-family prefix rule (Binary*/Multiclass*/Multilabel*/Retrieval*). A class with no
spec is a recorded skip, never a crash.
"""
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs.canon import SIZES, budget_cases
from metrics_tpu_torch.obs.canon import _inputs_for as _canon_inputs

__all__ = ["SIZES", "TraceCase", "budget_classes", "cases_for", "inner_spec", "ops_cases"]


@dataclass(frozen=True)
class TraceCase:
    """One ``(args, kwargs)`` update invocation to trace at one canonical size. ``args``
    are small real tensors whose shapes, dtypes and devices the fake ones take."""

    tag: str  # "canon" / "small" (+ ":variant" for kwarg variants)
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ClassCases:
    """One budgeted class: a constructor and its cases by size tag."""

    name: str
    make: Callable[[], Any]
    sizes: Dict[str, List[TraceCase]] = field(default_factory=dict)


def budget_classes(device: Any, seed: int = 0) -> Tuple[Dict[str, ClassCases], Dict[str, str]]:
    """``({class name: ClassCases}, {export: skip reason})`` over ``budget_cases`` at
    every size of :data:`SIZES`, the arguments on ``device``."""
    classes: Dict[str, ClassCases] = {}
    skipped: Dict[str, str] = {}
    for size in SIZES:
        cases, skips = budget_cases(device, seed, size)
        skipped.update(skips)
        for key, make, args, kwargs in cases:
            name, _, rest = key.partition(".update[")
            entry = classes.setdefault(name, ClassCases(name, make))
            entry.sizes.setdefault(size, []).append(TraceCase(rest[:-1], tuple(args), dict(kwargs)))
    return classes, skipped


def _normalize(raw: Any, tag: str) -> List[TraceCase]:
    """Accept hook/table output: a list of ``(args, kwargs)`` pairs, a bare args tuple,
    or a list of ``(tag, args, kwargs)`` triples; numpy arrays become CPU tensors."""
    cases: List[TraceCase] = []
    if raw is None:
        return cases
    if isinstance(raw, tuple) and all(isinstance(a, (np.ndarray, torch.Tensor)) for a in raw):
        raw = [(raw, {})]
    for entry in raw:
        if len(entry) == 3 and isinstance(entry[0], str):
            sub, args, kwargs = entry
            cases.append(TraceCase(f"{tag}:{sub}", _tensors(args), dict(kwargs)))
            continue
        args, kwargs = entry
        sub = ":" + ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) if kwargs else ""
        cases.append(TraceCase(tag + sub, _tensors(args), dict(kwargs)))
    return cases


def _tensors(args: Any) -> Tuple[Any, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a for a in args)


def _table(name: str, n: int, seed: int) -> Optional[list]:
    builder = _canon_inputs(name)
    return None if builder is None else builder(np.random.default_rng(seed), n)


def inner_spec(metric: Any, n: int, seed: int = 0) -> Optional[list]:
    """Raw spec list for a WRAPPED metric instance, resolved by class name: the wrapped
    metric's own hook wins, then the tables (``MulticlassAccuracy`` hits the
    ``Multiclass`` rule)."""
    hook = getattr(metric, "_san_input_specs", None)
    raw = hook(n) if hook is not None else None
    if raw is not None:
        return raw
    return _table(type(metric).__name__.lstrip("_"), n, seed)


def cases_for(name: str, instance: Any, seed: int = 0) -> Optional[Dict[str, List[TraceCase]]]:
    """``{size_tag: [TraceCase, ...]}`` for one metric by export name, or None when no
    spec exists (hook, table and family all miss)."""
    out: Dict[str, List[TraceCase]] = {}
    hook = getattr(instance, "_san_input_specs", None)
    for tag, n in SIZES.items():
        raw = hook(n) if hook is not None else None
        if raw is None:
            raw = _table(name, n, seed)
            if raw is None:
                return None
        out[tag] = _normalize(raw, tag)
    return out


# ---------------------------------------------------------------------------
# ops/ exact-kernel functional entry points (traced and budgeted like metrics)
# ---------------------------------------------------------------------------


def _f32(n: int, *rest: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(n).random((n, *rest), dtype=np.float32))


def _i32(n: int, high: int, *rest: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(n + 1).integers(0, high, (n, *rest), dtype=np.int32))


def _ops_entrypoints() -> Dict[str, Tuple[Callable, Callable[[int], list]]]:
    from metrics_tpu_torch.ops import clf_curve, confmat, rank, segment
    from metrics_tpu_torch.ops import sketch as sketch_ops

    pairs = lambda n: [((_f32(n), _i32(n, 2)), {})]  # noqa: E731
    return {
        "ops.binary_auroc_exact": (clf_curve.binary_auroc_exact, pairs),
        "ops.binary_average_precision_exact": (clf_curve.binary_average_precision_exact, pairs),
        "ops.multiclass_auroc_exact": (clf_curve.multiclass_auroc_exact, lambda n: [((_f32(n, 5), _i32(n, 5)), {})]),
        "ops.multiclass_average_precision_exact": (
            clf_curve.multiclass_average_precision_exact, lambda n: [((_f32(n, 5), _i32(n, 5)), {})]),
        "ops.multilabel_auroc_exact": (clf_curve.multilabel_auroc_exact,
                                       lambda n: [((_f32(n, 3), _i32(n, 2, 3)), {})]),
        "ops.multilabel_average_precision_exact": (
            clf_curve.multilabel_average_precision_exact, lambda n: [((_f32(n, 3), _i32(n, 2, 3)), {})]),
        "ops.binary_precision_recall_curve_padded": (clf_curve.binary_precision_recall_curve_padded, pairs),
        "ops.binary_roc_curve_padded": (clf_curve.binary_roc_curve_padded, pairs),
        "ops.grouped_retrieval_scores": (
            segment.grouped_retrieval_scores,
            lambda n: [((_i32(n, 8), _f32(n), _i32(n, 2)), {"metric": "precision", "top_k": 2})]),
        # the fused segmented multi-scan: two statistics in one pass
        "ops.segment_multi_scan": (
            lambda a, b, flags, **kw: segment.segment_multi_scan((a, b), flags, **kw),
            lambda n: [((_i32(n, 8), _i32(n, 8), _i32(n, 2).to(torch.bool)), {"ops": ("sum", "min")})]),
        "ops.confusion_counts": (
            confmat.confusion_counts,
            lambda n: [((_i32(n, 5), _i32(n, 5), _i32(n, 2).to(torch.bool)), {"num_classes": 5})]),
        "ops.ranked_targets": (rank.ranked_targets, pairs),
        "ops.monotone_key_descending": (rank.monotone_key_descending, lambda n: [((_f32(n),), {})]),
        "ops.sketch_hash_u32": (sketch_ops.hash_u32, lambda n: [((_f32(n),), {})]),
        # the histogram-form AP bounds at the shipping 2^12-bucket resolution
        "ops.average_precision_bounds_from_hists": (
            rank.average_precision_bounds_from_hists, lambda n: [((_i32(1 << 12, 9), _i32(1 << 12, 9)), {})]),
    }


def ops_cases() -> Dict[str, Tuple[Callable, Dict[str, List[TraceCase]]]]:
    """``{entry_key: (fn, {size_tag: cases})}`` for the ops/ entry points, the arguments
    as CPU tensors (the runner moves their fakes to the trace's device)."""
    out = {}
    for key, (fn, builder) in _ops_entrypoints().items():
        out[key] = (fn, {tag: _normalize(builder(n), tag) for tag, n in SIZES.items()})
    return out
