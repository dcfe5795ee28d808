"""Runtime cost cross-check: do the measured kernel launches of each metric's update
hold to the launch budget stamped on the card? (counterpart of
``metrics_tpu/obs/costcheck.py``)

The JAX package checks its runtime against ``tmsan_costs.json``, a budget that its
static analysis records without running anything: one dispatch per update. The port's
budget is measured instead: ``launch_budget.json`` beside this module, written on the
card by ``python -m metrics_tpu_torch.obs.costcheck --write-budget`` (:func:`write_budget`)
and committed. For every class that the JAX budget holds at its canonical batch
(``<Class>.update[canon]``; inputs from :mod:`metrics_tpu_torch.obs.canon`) an entry
has, for one eager update:

- ``launches_per_update``: the hand-kernel launches, by kernel (the wrappers' counts);
- ``kernel_launches_per_update``: those that the class's own update is credited with
  (``_build.note_launch`` credits the innermost update, so a wrapper's child metrics
  keep theirs), which is what :func:`crosscheck` holds the registry to;
- ``cuda_kernels_per_update`` and ``cuda_copies_per_update``: every CUDA kernel, and
  every copy and memset, in a profiler trace of the update (None off the card).

``fused.collection_update[canon]`` holds the canonical collection's fused step: one
replay a step and the hand-kernel launches inside it. The file is stamped with the
torch version, the CUDA version and the card's name (the JAX ``jax``/``backend``); on
a skew the comparison still runs, and a drift is a note, not a warning.

With the gate on, a budgeted class's ``kernel_launches / updates`` above its figure
times ``1 + tolerance`` is a drift (a :class:`CostDriftWarning`), below its figure
times ``1 - tolerance`` is amortized (updates through a fused step, which credit the
``fused`` scope), and where the figure is 0 any launch is a drift. With the gate off
nothing is counted and :func:`crosscheck` returns an empty report.
"""
import json
import os
import warnings
from typing import Any, Dict, Optional

import torch

from metrics_tpu_torch.obs import registry as _reg

#: launch-count drift beyond this fraction of the budget is a warning
DRIFT_TOLERANCE = 0.15

#: registry scopes that are infrastructure, not budgeted metric classes
_INFRA_SCOPES = frozenset(
    {"fused", "fleet", "scopes", "bench", "jax", "sync", "ckpt", "collection", "health"}
)

BUDGET_FILENAME = "launch_budget.json"
FUSED_KEY = "fused.collection_update[canon]"
#: updates in the profiler trace that counts an update's CUDA kernels and copies
TRACE_REPS = 10


class CostDriftWarning(RuntimeWarning):
    """Measured kernel launches drifted past tolerance from the launch budget."""


def default_costs_path() -> Optional[str]:
    """``launch_budget.json`` beside this module, where it exists."""
    cand = os.path.join(os.path.dirname(os.path.abspath(__file__)), BUDGET_FILENAME)
    return cand if os.path.exists(cand) else None


def _class_of(key: str) -> Optional[str]:
    head, _, _ = key.partition("[")
    cls, dot, op = head.partition(".")
    # a class name, private ones too (the root exports' ``_PeakSignalNoiseRatio``)
    if dot and op == "update" and cls.lstrip("_")[:1].isupper():
        return cls
    return None


def budgeted_classes(payload: Dict[str, Any]) -> Dict[str, int]:
    """Metric class names with at least one ``<Class>.update[...]`` budget entry,
    mapped to how many input variants the budget records for them."""
    out: Dict[str, int] = {}
    for key in payload.get("entries", {}):
        cls = _class_of(key)
        if cls is not None:
            out[cls] = out.get(cls, 0) + 1
    return out


def _budget_figures(payload: Dict[str, Any]) -> Dict[str, float]:
    """Each budgeted class's credited launches per update, the mean over its variants."""
    sums: Dict[str, float] = {}
    counts = budgeted_classes(payload)
    for key, entry in payload.get("entries", {}).items():
        cls = _class_of(key)
        if cls is not None:
            sums[cls] = sums.get(cls, 0.0) + float(entry["kernel_launches_per_update"])
    return {cls: sums[cls] / counts[cls] for cls in sums}


def running_stamp() -> Dict[str, Optional[str]]:
    """The torch version, CUDA version and card this process runs (``"cpu"`` without one)."""
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu",
    }


def _stamp_text(stamp: Dict[str, Any]) -> str:
    return f"torch={stamp.get('torch')}/cuda={stamp.get('cuda')}/{stamp.get('device')}"


def _scope_wall_s(counters: Dict[str, Any]) -> Optional[float]:
    """Sum the wall-time timers recorded for a scope (None when none exist)."""
    total = None
    for value in counters.values():
        if isinstance(value, dict) and "total_s" in value:
            total = (total or 0.0) + float(value["total_s"])
    return total


def crosscheck(
    costs_path: Optional[str] = None,
    tolerance: float = DRIFT_TOLERANCE,
    snapshot: Optional[Dict[str, Dict[str, Any]]] = None,
    warn: bool = True,
) -> Dict[str, Any]:
    """Compare measured kernel launches against the launch budget; return a report.

    Report layout (the JAX one, with ``budget_stamp`` in place of ``static_jax``)::

        {"costs_path", "tolerance", "budget_stamp", "version_ok",
         "checked":   [{scope, updates, kernel_launches, launches_per_update,
                        budget_launches_per_update, budget_variants, wall_s?}, ...],
         "drifts":    [same rows, measured > budget * (1 + tolerance)],
         "amortized": [same rows, measured < budget * (1 - tolerance)],
         "unbudgeted": [scopes measured but absent from the budget],
         "notes": [...]}

    ``warn=True`` raises one :class:`CostDriftWarning` naming every drifted scope
    (a note instead where the budget's stamp is not this process's).
    """
    report: Dict[str, Any] = {
        "costs_path": None,
        "tolerance": tolerance,
        "budget_stamp": None,
        "version_ok": None,
        "checked": [],
        "drifts": [],
        "amortized": [],
        "unbudgeted": [],
        "notes": [],
    }
    path = costs_path or default_costs_path()
    if path is None or not os.path.exists(path):
        report["notes"].append(
            f"{BUDGET_FILENAME} not found: run `python -m metrics_tpu_torch.obs.costcheck"
            " --write-budget` on the card to record the launch budget"
        )
        return report
    try:
        with open(path, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:  # a broken budget file is a note, not a crash
        report["notes"].append(f"failed to load {path}: {exc}")
        return report
    report["costs_path"] = path
    stamp, running = payload.get("stamp", {}), running_stamp()
    report["budget_stamp"] = _stamp_text(stamp)
    version_ok = all(stamp.get(k) == running[k] for k in running)
    report["version_ok"] = bool(version_ok)
    if not version_ok:
        report["notes"].append(
            f"budget recorded on {_stamp_text(stamp)} but running {_stamp_text(running)}:"
            " drift reported as notes, not warnings"
        )

    budget = budgeted_classes(payload)
    figures = _budget_figures(payload)
    snap = snapshot if snapshot is not None else _reg.snapshot()

    for scope in sorted(snap):
        if scope in _INFRA_SCOPES:
            continue
        counters = snap[scope]
        updates = counters.get("updates")
        if not isinstance(updates, (int, float)) or updates <= 0:
            continue
        launches = counters.get("kernel_launches", 0)
        if not isinstance(launches, (int, float)):
            continue
        if scope not in budget:
            report["unbudgeted"].append(scope)
            continue
        figure = figures[scope]
        row: Dict[str, Any] = {
            "scope": scope,
            "updates": int(updates),
            "kernel_launches": int(launches),
            "launches_per_update": round(launches / updates, 4),
            "budget_launches_per_update": figure,
            "budget_variants": budget[scope],
        }
        wall = _scope_wall_s(counters)
        if wall is not None:
            row["wall_s"] = round(wall, 6)
        ratio = launches / updates
        if ratio > figure * (1.0 + tolerance):
            report["drifts"].append(row)
        elif ratio < figure * (1.0 - tolerance):
            report["amortized"].append(row)
        else:
            report["checked"].append(row)

    if report["drifts"]:
        msg = "; ".join(
            f"{r['scope']}: {r['launches_per_update']:.2f} launches/update"
            f" vs budget {r['budget_launches_per_update']:.2f}"
            + (f" (+{(r['launches_per_update'] / r['budget_launches_per_update'] - 1) * 100:.0f}%)"
               if r["budget_launches_per_update"] else " (none budgeted)")
            for r in report["drifts"]
        )
        text = (
            f"metrics_tpu_torch.obs: runtime launch counts drifted past the +{tolerance * 100:.0f}% launch"
            f" budget from {os.path.basename(path)} — {msg}. The serving path is launching more"
            " kernels per update than the budget stamped on the card; fix the launch regression or"
            " refresh the budget with an explanation."
        )
        if warn and version_ok:
            warnings.warn(text, CostDriftWarning, stacklevel=2)
        else:
            report["notes"].append(text)
    return report


# --------------------------------------------------------------- the budget


def kernel_wrappers() -> Dict[str, Any]:
    """The hand-kernel wrappers by kernel name; each counts its ``launches``."""
    from metrics_tpu_torch.ops import greedy_match, histogram, kendall, segment

    return {
        "histogram": histogram.histogram_cuda,
        "histogram_batched": histogram.histogram_batched_cuda,
        "segment_scan": segment.segment_scan_cuda,
        "kendall_pairs": kendall.kendall_pairs_cuda,
        "greedy_match": greedy_match.greedy_match_cuda,
    }


def _launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def count_cuda_events(fn, reps: int, tries: int = 3) -> Dict[str, float]:
    """CUDA kernels and copies (memcpy, memset) per ``fn()`` call, from profiler traces
    of ``reps`` calls: each the active step of a schedule whose warm-up step makes the
    same calls first. Late in a long process a trace can lose device events (it never
    gains any), so the most that any of ``tries`` traces holds is kept."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels = copies = 0
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        kernels = max(kernels, sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset"))))
        copies = max(copies, sum(e.count for e in events if e.key.startswith(("Memcpy", "Memset"))))
    return {"cuda_kernels_per_update": kernels / reps, "cuda_copies_per_update": copies / reps}


def measure_update(make, args, kwargs, device: Any) -> Dict[str, Any]:
    """One budget entry: the launches of one eager update of a fresh ``make()`` metric
    (after one warm-up update), with the gate on for that update."""
    metric = make()
    metric.update(*args, **kwargs)  # the first call builds and loads what it needs
    scope = type(metric).__name__
    prev = _reg.enabled()
    _reg.enable()
    try:
        before, credited = _launch_counts(), _reg.REGISTRY.get(scope, "kernel_launches")
        metric.update(*args, **kwargs)
        after, credited = _launch_counts(), _reg.REGISTRY.get(scope, "kernel_launches") - credited
    finally:
        if not prev:
            _reg.disable()
    entry: Dict[str, Any] = {
        "launches_per_update": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        "kernel_launches_per_update": credited,
        "cuda_kernels_per_update": None,
        "cuda_copies_per_update": None,
    }
    if torch.device(device).type == "cuda":
        entry.update(count_cuda_events(lambda: metric.update(*args, **kwargs), TRACE_REPS))
    return entry


def measure_fused_step(device: Any, seed: int = 0) -> Dict[str, Any]:
    """The canonical collection's fused step at the canonical batch: replays and
    hand-kernel launches per step, over steps after the capture."""
    from metrics_tpu_torch.core.fused import canonical_collection, engine_for
    from metrics_tpu_torch.obs.canon import CANON

    g = torch.Generator(device="cpu").manual_seed(seed)
    preds, target = torch.rand(CANON, generator=g), torch.randint(0, 2, (CANON,), generator=g, dtype=torch.int32)
    preds, target = preds.to(device), target.to(device)
    coll = canonical_collection(True, device=device)
    coll.update(preds, target)  # the capture (a compiled step on the CPU)
    stats = engine_for(coll).stats
    launches0, steps0 = _launch_counts(), stats["launches"]
    steps = 10
    for _ in range(steps):
        coll.update(preds, target)
    after = _launch_counts()
    return {
        "replays_per_step": (stats["launches"] - steps0) / steps,
        "launches_per_replay": {k: (after[k] - launches0[k]) / steps for k in after if after[k] != launches0[k]},
    }


def write_budget(path: Optional[str] = None, device: Any = "cuda", seed: int = 0) -> Dict[str, Any]:
    """Measure every budgeted update and the fused step on ``device`` and write the
    budget to ``path`` (this module's ``launch_budget.json`` by default); returns it.
    On the CPU every launch count reads 0 and the trace counts None."""
    from metrics_tpu_torch.obs.canon import CANON, budget_cases

    if torch.device(device).type == "cuda":
        from metrics_tpu_torch import _build

        _build.build()
    cases, skipped = budget_cases(device, seed)
    entries: Dict[str, Any] = {}
    for key, make, args, kwargs in cases:
        entries[key] = measure_update(make, args, kwargs, device)
    entries[FUSED_KEY] = measure_fused_step(device, seed)
    stamp = running_stamp()
    payload = {
        "version": 1,
        "comment": (
            "launch budget of metrics_tpu_torch: hand-kernel launches, CUDA kernels and copies of one"
            f" eager update of each class at the canonical batch ({CANON}), and the canonical fused"
            " step; measured on the card; refresh with `python -m metrics_tpu_torch.obs.costcheck"
            " --write-budget` and commit the diff with its explanation."
        ),
        "stamp": stamp,
        "batch": CANON,
        "entries": entries,
        "skipped": skipped,
    }
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)), BUDGET_FILENAME)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return payload


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Write or check the launch budget of metrics_tpu_torch.")
    parser.add_argument("--write-budget", action="store_true", help="measure on --device and write the budget")
    parser.add_argument("--path", default=None, help="budget file (default: beside this module)")
    parser.add_argument("--device", default="cuda")
    cli = parser.parse_args()
    if not cli.write_budget:
        parser.error("nothing to do: pass --write-budget")
    written = write_budget(cli.path, cli.device)
    print(json.dumps({"entries": len(written["entries"]), "skipped": len(written["skipped"]),
                      "stamp": written["stamp"]}))
