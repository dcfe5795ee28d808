"""tmrace orchestration: parse -> link -> rules -> baseline -> report.

Pure host AST work — nothing imports or executes the analyzed modules, so the
sweep runs on a machine with no card and takes a few seconds.
"""
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis import baseline as baseline_mod
from metrics_tpu_torch.analysis.findings import RACE_RULES, Finding
from metrics_tpu_torch.analysis.jitmap import load_package
from metrics_tpu_torch.analysis.race import handler_rules, lock_rules, order_graph
from metrics_tpu_torch.analysis.race.thread_model import RaceModel, build_model
from metrics_tpu_torch.analysis.runner import _find_repo_root


@dataclass
class RaceReport:
    """One tmrace run: the linked model plus rule output and baseline split."""

    findings: List[Finding] = field(default_factory=list)  # waived included
    new_findings: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, str, str]] = field(default_factory=list)
    parse_errors: Dict[str, str] = field(default_factory=dict)
    #: role -> entry-point count (how the thread-role model carved the package)
    roles: Dict[str, int] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)
    model: Optional[RaceModel] = None

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        return 1 if self.new_findings else 0


def _obs_inc(name: str, value: float = 1) -> None:
    from metrics_tpu_torch.obs import registry as _obs

    if _obs._ENABLED:
        _obs.REGISTRY.inc("race", name, value)


#: rule id -> obs counter suffix (mirrors Rule.counter in findings.py)
_RULE_COUNTERS = {
    "TMR-UNLOCKED": "unlocked",
    "TMR-ORDER": "order_cycles",
    "TMR-HOLD-HOST": "hold_host",
    "TMR-HANDLER": "handler",
    "TMR-LEAK": "leaks",
}


def run_race(
    target: str = "metrics_tpu_torch",
    baseline_path: Optional[str] = None,
    repo_root: Optional[str] = None,
) -> RaceReport:
    """Analyze ``target`` (package dir or single file) for thread-safety."""
    t0 = time.perf_counter()
    report = RaceReport()
    repo_root = repo_root or _find_repo_root(target)

    files = load_package(target, repo_root)
    model = build_model(files)
    report.model = model
    report.parse_errors = dict(model.errors)

    report.findings.extend(lock_rules.unlocked_findings(model))
    report.findings.extend(lock_rules.hold_host_findings(model))
    report.findings.extend(lock_rules.leak_findings(model))
    report.findings.extend(order_graph.order_findings(model))
    report.findings.extend(handler_rules.handler_findings(model))
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))

    if baseline_path is None:
        baseline_path = baseline_mod.default_baseline_path(repo_root)
    waivers = baseline_mod.load_baseline(baseline_path) if baseline_path else {}
    race_waivers = baseline_mod.scope_waivers(waivers, RACE_RULES)
    report.new_findings, report.unused_waivers = baseline_mod.apply_baseline(
        report.findings, race_waivers
    )

    n_funcs = 0
    n_spawns = 0
    for _m, func in model.all_functions():
        n_funcs += 1
        n_spawns += len(func.spawns)
        for role in func.roles:
            report.roles[role] = report.roles.get(role, 0) + 1

    _obs_inc("findings", len(report.findings))
    for f in report.findings:
        suffix = _RULE_COUNTERS.get(f.rule)
        if suffix:
            _obs_inc(suffix)

    report.stats = {
        "files": len(model.modules),
        "functions": n_funcs,
        "locks": len(model.locks),
        "roles": len(report.roles),
        "threads": n_spawns,
        "findings": len(report.findings),
        "waived": len(report.waived),
        "new": len(report.new_findings),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    return report
