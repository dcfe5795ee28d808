"""tmown dataflow rules: turn the flow walk's events into findings (counterpart of
``metrics_tpu/analysis/own/donation_rules.py``).

The model (``buffer_model.py``) records *facts*; this module is the *policy*
layer — which events become findings, under which rule id, with what message.

Symbols: the function qualname for value-lifetime rules, and
``qualname.<name>`` for TMO-KEY-GAP (one waiver per missing key input, so a
triaged by-design gap stays waived when a new gap appears in the same function).
"""
from typing import List

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.own.buffer_model import OwnModel

#: event kind -> (rule id, message prefix)
_EVENT_RULES = {
    "donate_alias": (
        "TMO-DONATE-ALIAS",
        "possibly-aliasing tensor written in place without an owning copy "
        "(take .clone() first, as ckpt/restore.py's restore does): ",
    ),
    "use_after_donate": (
        "TMO-USE-AFTER-DONATE",
        "read after a replay overwrote it, before re-pointing: ",
    ),
    "double_donate": (
        "TMO-DOUBLE-DONATE",
        "one tensor in two in-place positions of one step: ",
    ),
    "snapshot_gap": (
        "TMO-SNAPSHOT-GAP",
        "snapshot-before-replay guard missing: ",
    ),
    "key_gap": (
        "TMO-KEY-GAP",
        "step-cache key gap: ",
    ),
}


def dataflow_findings(model: OwnModel) -> List[Finding]:
    """All findings from the five per-function dataflow rules, deduplicated
    on (rule, path, symbol, line) and sorted for stable output."""
    out: List[Finding] = []
    seen = set()
    for _m, func in model.all_functions():
        for event in func.events:
            rule, prefix = _EVENT_RULES[event.kind]
            key = (rule, event.path, event.symbol, event.line)
            if key in seen:
                continue
            seen.add(key)
            out.append(
                Finding(
                    rule=rule,
                    path=event.path,
                    line=event.line,
                    col=event.col,
                    symbol=event.symbol,
                    message=prefix + event.detail,
                )
            )
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    return out
