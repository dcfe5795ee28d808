"""Crosscheck: tmlint's source-text verdicts vs the card's record of synchronising
calls (a copy of ``metrics_tpu/analysis/san/crosscheck.py``, with the same
signatures and output).

The evidence has the JAX package's shape, filled from the card
(``san/runner.py``): ``callbacks`` are ``(what, path, line, function)`` for every
line of the port that made a synchronising call inside a traced update (the
card's ``torch.cuda.set_sync_debug_mode``), where the JAX package lists the
callback equations of its jaxprs; ``footprint`` is every ``(path, line)`` of the
port that ran inside a traced update (``sys.monitoring`` line events), where the
JAX package takes the source lines its traced equations attribute to.

Two directions:

1. **TMS-LINTGAP** — every synchronising line must correspond to a TM-HOSTSYNC
   finding (waived or not) at the same source location. A sync in a function
   tmlint considered clean means the AST model has a blind spot: fix the code
   AND the model.

2. **TM-HOSTSYNC waiver corroboration** — a waiver asserts the flagged host
   work stays off traced paths. Each one is checked against the footprint:

   - *corroborated-by-absence*: none of the waived finding's lines ran inside
     a traced update — the "eager-only / guarded" claim holds;
   - *corroborated-by-presence*: the line ran and synchronised — the host work
     is known and kept;
   - **TMS-STALE-WAIVER** otherwise: the waived line ran inside traced updates
     without a sync, so the waiver's claim no longer describes the code.
     Re-triage it.

The messages and statuses are the JAX module's words ("jaxpr-level", "traced
graphs"), so that both crosschecks give equal output on equal evidence.
"""
from typing import Dict, List, Set, Tuple

from metrics_tpu_torch.analysis.findings import Finding

#: how far (in lines) a synchronising line may sit from the TM-HOSTSYNC finding
#: that covers it — a sync is often reported on the next line of a statement
_LINE_SLACK = 2


def lintgap_findings(
    callbacks: List[Tuple[str, str, int, str]],
    lint_findings: List[Finding],
) -> List[Finding]:
    """Callbacks in traced graphs that no TM-HOSTSYNC finding/waiver covers."""
    hostsync = [f for f in lint_findings if f.rule == "TM-HOSTSYNC"]
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for prim, path, line, func in callbacks:
        if not path or (path, line) in seen:
            continue  # no repo attribution -> already reported as TMS-CALLBACK
        seen.add((path, line))
        covered = any(
            f.path == path
            and (
                abs(f.line - line) <= _LINE_SLACK
                or (func and (f.symbol.endswith(func) or f.symbol.split(".")[-1] == func))
            )
            for f in hostsync
        )
        if not covered:
            out.append(
                Finding(
                    rule="TMS-LINTGAP",
                    path=path,
                    line=line,
                    col=0,
                    symbol=func or "<unknown>",
                    message=(
                        f"jaxpr-level `{prim}` at {path}:{line} but tmlint reports no "
                        "TM-HOSTSYNC there: the AST tier has a blind spot — fix the host "
                        "call AND extend trace_rules.py so the cheap tier catches it"
                    ),
                )
            )
    return out


def corroborate_waivers(
    waivers: Dict[Tuple[str, str, str], str],
    lint_findings: List[Finding],
    footprint: Set[Tuple[str, int]],
    callbacks: List[Tuple[str, str, int, str]],
) -> Tuple[List[Finding], Dict[str, str]]:
    """(stale_findings, {waiver_key_str: status}) for every TM-HOSTSYNC waiver."""
    callback_lines = {(p, ln) for _, p, ln, _ in callbacks if p}
    status: Dict[str, str] = {}
    stale: List[Finding] = []
    for key in sorted(k for k in waivers if k[0] == "TM-HOSTSYNC"):
        rule, path, symbol = key
        key_str = ":".join(key)
        matched = [f for f in lint_findings if f.key() == key]
        if not matched:
            status[key_str] = "unused (no current TM-HOSTSYNC finding; tmlint reports it stale)"
            continue
        traced_hits = [
            f for f in matched if (f.path, f.line) in footprint and (f.path, f.line) not in callback_lines
        ]
        as_callback = [f for f in matched if (f.path, f.line) in callback_lines]
        if traced_hits:
            f0 = traced_hits[0]
            status[key_str] = f"STALE: waived line {f0.path}:{f0.line} participates in traced graphs"
            stale.append(
                Finding(
                    rule="TMS-STALE-WAIVER",
                    path=path,
                    line=f0.line,
                    col=0,
                    symbol=symbol,
                    message=(
                        f"TM-HOSTSYNC waiver for `{symbol}` claims host-only execution, but "
                        f"{f0.path}:{f0.line} appears in the traced source footprint as device "
                        "computation: the code moved under the waiver — re-triage it"
                    ),
                )
            )
        elif as_callback:
            status[key_str] = "corroborated-by-presence (traced as an explicit callback equation)"
        else:
            status[key_str] = "corroborated-by-absence (waived lines in no traced jaxpr)"
    return stale, status
