"""tmown orchestration: parse -> link -> rules -> baseline -> report (counterpart of
``metrics_tpu/analysis/own/runner.py``).

Pure host AST work — nothing imports or executes the analyzed modules, so the
sweep runs on a machine without a card in a few seconds.
"""
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis import baseline as baseline_mod
from metrics_tpu_torch.analysis.findings import OWN_RULES, Finding
from metrics_tpu_torch.analysis.jitmap import load_package
from metrics_tpu_torch.analysis.own import donation_rules, engine_contract
from metrics_tpu_torch.analysis.own.buffer_model import OwnModel, build_model
from metrics_tpu_torch.analysis.runner import _find_repo_root


@dataclass
class OwnReport:
    """One tmown run: the linked model plus rule output and baseline split."""

    findings: List[Finding] = field(default_factory=list)  # waived included
    new_findings: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, str, str]] = field(default_factory=list)
    parse_errors: Dict[str, str] = field(default_factory=dict)
    #: engine -> component matrix (the worksheet's source)
    contract: Dict[str, Dict] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)
    model: Optional[OwnModel] = None

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        return 1 if self.new_findings else 0

    def drift_worksheet(self) -> Dict:
        drift = [f for f in self.findings if f.rule == "TMO-ENGINE-DRIFT"]
        return engine_contract.worksheet(self.contract, drift)


def _obs_inc(name: str, value: float = 1) -> None:
    from metrics_tpu_torch.obs import registry as _obs

    if _obs._ENABLED:
        _obs.REGISTRY.inc("own", name, value)


#: rule id -> obs counter suffix (mirrors Rule.counter in findings.py)
_RULE_COUNTERS = {
    "TMO-DONATE-ALIAS": "donate_alias",
    "TMO-USE-AFTER-DONATE": "use_after_donate",
    "TMO-DOUBLE-DONATE": "double_donate",
    "TMO-SNAPSHOT-GAP": "snapshot_gap",
    "TMO-KEY-GAP": "key_gap",
    "TMO-ENGINE-DRIFT": "engine_drift",
}


def run_own(
    target: str = "metrics_tpu_torch",
    baseline_path: Optional[str] = None,
    repo_root: Optional[str] = None,
) -> OwnReport:
    """Analyze ``target`` (package dir or single file) for buffer ownership."""
    t0 = time.perf_counter()
    report = OwnReport()
    repo_root = repo_root or _find_repo_root(target)

    files = load_package(target, repo_root)
    model = build_model(files)
    report.model = model
    report.parse_errors = dict(model.errors)

    report.findings.extend(donation_rules.dataflow_findings(model))
    report.contract = engine_contract.extract_contract(model)
    report.findings.extend(engine_contract.drift_findings(report.contract))
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))

    if baseline_path is None:
        baseline_path = baseline_mod.default_baseline_path(repo_root)
    waivers = baseline_mod.load_baseline(baseline_path) if baseline_path else {}
    own_waivers = baseline_mod.scope_waivers(waivers, OWN_RULES)
    report.new_findings, report.unused_waivers = baseline_mod.apply_baseline(
        report.findings, own_waivers
    )

    n_funcs = 0
    n_exec = 0
    n_donating = 0
    for _m, func in model.all_functions():
        n_funcs += 1
        n_exec += func.exec_sites
        if func.builds_donating or func.returns_donating:
            n_donating += 1

    _obs_inc("findings", len(report.findings))
    for f in report.findings:
        suffix = _RULE_COUNTERS.get(f.rule)
        if suffix:
            _obs_inc(suffix)

    report.stats = {
        "files": len(model.modules),
        "functions": n_funcs,
        "donating": n_donating,
        "exec_sites": n_exec,
        "engines": len(report.contract),
        "findings": len(report.findings),
        "waived": len(report.waived),
        "new": len(report.new_findings),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    return report
