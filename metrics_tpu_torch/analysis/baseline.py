"""Baseline (waiver) file handling (a copy of ``metrics_tpu/analysis/baseline.py``;
the file format is the JAX one).

``metrics_tpu_torch/analysis/tmlint_baseline.json`` records findings that were triaged and deliberately waived — each with a human reason. CI fails only
on findings NOT matched by the baseline, so the analyzer can land on a large
existing codebase and still guard every *new* line.

Waivers match on ``(rule, path, symbol)`` — not line numbers, so unrelated
edits don't churn the baseline. A waiver covers every finding with its key
(one symbol can produce several same-rule findings; they share one triage).
"""
import json
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis.findings import Finding

BASELINE_FILENAME = "tmlint_baseline.json"


def load_baseline(path: str) -> Dict[Tuple[str, str, str], str]:
    """{(rule, path, symbol): reason} from a baseline file."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[Tuple[str, str, str], str] = {}
    for entry in data.get("waivers", []):
        reason = entry.get("reason", "")
        if not reason:
            raise ValueError(
                f"baseline waiver {entry.get('rule')}:{entry.get('path')}:{entry.get('symbol')}"
                " has no reason — every waiver must say why it is safe"
            )
        out[(entry["rule"], entry["path"], entry["symbol"])] = reason
    return out


def scope_waivers(
    waivers: Dict[Tuple[str, str, str], str], rules: Iterable[str]
) -> Dict[Tuple[str, str, str], str]:
    """Restrict a waiver table to the given rule ids.

    The baseline file is shared between the port's three tiers — tmlint (TM-*),
    the card's crosscheck (TMS-*) and tmrace (TMR-*). Each tier scopes the table
    to its own rule namespace before :func:`apply_baseline`, so a tier applies —
    and reports staleness for — only the waivers it can possibly match. The scope
    sets (``LINT_RULES``, ``SAN_RULES``, ``RACE_RULES`` in ``findings.py``)
    partition ``RULES``, so every waiver belongs to exactly one tier.
    """
    allowed = set(rules)
    return {k: v for k, v in waivers.items() if k[0] in allowed}


def apply_baseline(
    findings: List[Finding], waivers: Dict[Tuple[str, str, str], str]
) -> Tuple[List[Finding], List[Tuple[str, str, str]]]:
    """Mark waived findings in place; returns (new_findings, unused_waiver_keys)."""
    used: Set[Tuple[str, str, str]] = set()
    new: List[Finding] = []
    for f in findings:
        reason = waivers.get(f.key())
        if reason is not None:
            f.waived = True
            f.waive_reason = reason
            used.add(f.key())
        else:
            new.append(f)
    unused = sorted(k for k in waivers if k not in used)
    return new, unused


def write_baseline(path: str, findings: Iterable[Finding], reason: str) -> int:
    """Write a baseline waiving every given finding with one shared reason.

    Meant for bootstrapping (``--write-baseline``); triaged per-finding reasons
    should then be edited in. Returns the number of waivers written.
    """
    seen: Set[Tuple[str, str, str]] = set()
    waivers = []
    for f in sorted(findings, key=lambda f: f.key()):
        if f.key() in seen:
            continue
        seen.add(f.key())
        waivers.append(
            {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "reason": f.waive_reason or reason,
            }
        )
    payload = {
        "version": 1,
        "comment": (
            "tmlint waivers of metrics_tpu_torch: findings triaged as safe. Matched"
            " on (rule, path, symbol); every entry needs its own reason."
        ),
        "waivers": waivers,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return len(waivers)


def default_baseline_path(repo_root: str) -> Optional[str]:
    """The port's own baseline under ``repo_root``, if the tree holds it."""
    cand = os.path.join(repo_root, "metrics_tpu_torch", "analysis", BASELINE_FILENAME)
    return cand if os.path.exists(cand) else None
