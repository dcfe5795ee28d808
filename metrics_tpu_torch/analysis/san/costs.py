"""Cost budget: what a fake trace of each entry dispatches, as a static perf-regression
gate (counterpart of ``metrics_tpu/analysis/san/costs.py``).

For every traced entry at the canonical shape, one more trace on fake tensors (nothing
executes, nothing is allocated) measures

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions, attention: the ops it has formulas for);
- ``bytes_accessed``: the sum of each dispatched op's input and output bytes (views
  excluded);
- ``peak_bytes``: the most bytes of fake storage made in the trace alive at once.

``metrics_tpu_torch/analysis/san_costs.json`` records them. It is written on the card,
on fake ``cuda`` tensors, by ``python -m metrics_tpu_torch.analysis --san
--write-costs``, and stamped with torch, CUDA and the card's name.
:func:`compare_costs` fails CI (TMS-BUDGET findings) on unexplained growth above
:data:`BUDGET_TOLERANCE`; when the stamp differs from the running torch or device
(a CPU run against the card's budget, another torch), the comparison still runs but
gives notes, not findings: cross-version drift is torch's business, same-version drift
is a regression of this package.

This budget is distinct from ``obs/launch_budget.json`` (``obs/costcheck.py``), which
counts the kernels each eager update really launches on the card.
"""
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis.findings import Finding

COSTS_FILENAME = "san_costs.json"
#: growth beyond this fraction of the recorded budget is a TMS-BUDGET finding
BUDGET_TOLERANCE = 0.15
#: the cost dimensions the budget tracks, in report order
COST_KEYS = ("flops", "bytes_accessed", "peak_bytes")


def measure_entry(trace: Callable[[Callable[..., Any], Any], Any], fn: Callable[..., Any]) -> Optional[Dict[str, float]]:
    """Costs of ``fn`` traced by ``trace(fn, counter)`` (the runner's recorded fake trace
    on its inputs, which returns its
    :class:`~metrics_tpu_torch.analysis.san.dispatch_rules.GraphFacts`) under the
    ``FlopCounterMode`` ``counter``; never executes it. The inputs' own bytes count as
    read, not as the trace's storage."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    facts = trace(fn, counter)
    if facts is None:
        return None
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float(facts.bytes_accessed),
            "peak_bytes": float(facts.peak_bytes)}


def stamp(device: Any) -> Dict[str, str]:
    """torch, CUDA and the device's name: what the budget was measured with."""
    import torch

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda), "device": name}


def load_costs(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_costs(path: str, entries: Dict[str, Dict[str, float]], device: Any = "cuda") -> int:
    payload = {
        "version": 1,
        "comment": (
            "tmsan cost budget: flops / bytes accessed / peak bytes per (entry, canonical shape),"
            " from one trace on fake tensors of the stamped device. CI fails on >15% unexplained"
            " growth (same stamp); refresh on the card with `python -m metrics_tpu_torch.analysis"
            " --san --write-costs` and commit the diff with its explanation. Not"
            " obs/launch_budget.json, which counts real kernel launches."
        ),
        **stamp(device),
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
    return len(payload["entries"])


def default_costs_path(repo_root: str) -> Optional[str]:
    cand = os.path.join(repo_root, "metrics_tpu_torch", "analysis", COSTS_FILENAME)
    return cand if os.path.exists(cand) else None


def _breaches(current: Dict[str, float], budget: Dict[str, float]) -> List[str]:
    out = []
    for key in COST_KEYS:
        cur, ref = float(current.get(key, 0.0)), float(budget.get(key, 0.0))
        if ref <= 0.0:
            continue  # zero-cost reference: nothing meaningful to gate on
        growth = cur / ref - 1.0
        if growth > BUDGET_TOLERANCE and not math.isclose(cur, ref):
            out.append(f"{key} {ref:.0f} -> {cur:.0f} (+{growth * 100:.0f}%)")
    return out


def compare_costs(
    current: Dict[str, Dict[str, float]],
    budget_payload: Dict[str, Any],
    anchors: Dict[str, Tuple[str, int]],
    running: Optional[Dict[str, str]] = None,
) -> Tuple[List[Finding], List[str]]:
    """(findings, notes) comparing measured costs against the checked-in budget.

    ``anchors``: entry key -> (repo_relative_path, line) for finding placement.
    ``running``: the stamp of this run (:func:`stamp`); a budget stamped otherwise
    gives notes, not findings.
    """
    findings: List[Finding] = []
    notes: List[str] = []
    budget: Dict[str, Dict[str, float]] = budget_payload.get("entries", {})
    recorded = {k: budget_payload.get(k) for k in ("torch", "cuda", "device")}
    version_ok = running is not None and all(recorded[k] == running.get(k) for k in recorded)
    if not version_ok:
        now = "/".join(str((running or {}).get(k)) for k in recorded)
        notes.append(
            f"budget recorded on {'/'.join(str(v) for v in recorded.values())} but running {now}: cost drift"
            " reported as warnings, not failures"
        )

    def emit(entry: str, message: str) -> None:
        path, line = anchors.get(entry, ("", 0))
        f = Finding(rule="TMS-BUDGET", path=path or COSTS_FILENAME, line=line, col=0, symbol=entry,
                    message=message)
        if version_ok:
            findings.append(f)
        else:
            notes.append(f"(version-skew warning) {f.format()}")

    for entry in sorted(current):
        if entry not in budget:
            emit(entry, f"no budget recorded for `{entry}`: run `python -m metrics_tpu_torch.analysis --san"
                        f" --write-costs` on the card and commit {COSTS_FILENAME}")
            continue
        over = _breaches(current[entry], budget[entry])
        if over:
            emit(entry, f"traced cost of `{entry}` grew past the +{BUDGET_TOLERANCE * 100:.0f}% budget:"
                        f" {'; '.join(over)} — fix the regression or refresh the budget (--write-costs) with an"
                        " explanation")
            continue
        shrunk = [
            f"{k} {budget[entry].get(k, 0):.0f} -> {current[entry].get(k, 0):.0f}"
            for k in COST_KEYS
            if float(budget[entry].get(k, 0.0)) > 0.0
            and float(current[entry].get(k, 0.0)) < float(budget[entry].get(k, 0.0)) * (1 - BUDGET_TOLERANCE)
        ]
        if shrunk:
            notes.append(f"`{entry}` improved >{BUDGET_TOLERANCE * 100:.0f}% below budget ({'; '.join(shrunk)}):"
                         " refresh with --write-costs to lock in the gain")
    for entry in sorted(set(budget) - set(current)):
        notes.append(f"budget entry `{entry}` no longer traced (metric removed or renamed): refresh with"
                     " --write-costs")
    return findings, notes
