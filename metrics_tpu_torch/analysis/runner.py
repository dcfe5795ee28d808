"""tmlint orchestration: files -> trace map -> rules -> baseline -> report
(counterpart of ``metrics_tpu/analysis/runner.py``)."""
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis import baseline as baseline_mod
from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.jitmap import PackageModel, load_package
from metrics_tpu_torch.analysis.trace_rules import run_retrace_rules, run_trace_rules


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)  # all, waived included
    new_findings: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, str, str]] = field(default_factory=list)
    skipped_classes: Dict[str, str] = field(default_factory=dict)
    parse_errors: Dict[str, str] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        return 1 if self.new_findings else 0


#: the package the analyzer belongs to: finding paths are anchored at its parent
PACKAGE = "metrics_tpu_torch"


def _find_repo_root(target: str) -> str:
    """Directory that repo-relative finding paths are anchored to.

    The parent of the ``metrics_tpu_torch`` package dir when the target is
    (inside) it, so paths come out as ``metrics_tpu_torch/ops/...`` and the
    baseline works from any cwd; otherwise the target's own parent.
    """
    absd = os.path.abspath(target)
    d = absd if os.path.isdir(absd) else os.path.dirname(absd)
    while True:
        if os.path.basename(d) == PACKAGE or os.path.exists(os.path.join(d, PACKAGE)):
            return d if os.path.basename(d) != PACKAGE else os.path.dirname(d)
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.dirname(absd) if os.path.isfile(absd) else absd
        d = parent


def _introspection_roots(repo_root: str, device: Any) -> Tuple[Dict[str, Dict[str, str]], Dict[str, str]]:
    """Trace entries from the live Metric registry: every non-host-side class's
    update/compute (the ``Metric._wrap_update`` / ``compute_from`` entries), the
    classes built on ``device``."""
    import inspect

    from metrics_tpu_torch.analysis.registry import introspect_classes
    from metrics_tpu_torch.core.metric import Metric

    roots: Dict[str, Dict[str, str]] = {}
    skipped: Dict[str, str] = {}
    seen = set()
    for item in introspect_classes(device):
        if item.instance is None:
            skipped[item.name] = item.skip_reason
            continue
        if item.cls in seen:
            continue
        seen.add(item.cls)
        if item.host_side:
            continue  # declared host-side by contract (_host_side_update hook)
        methods = ("update",) if getattr(item.cls, "_host_side_compute", False) else ("update", "compute")
        for method in methods:
            for base in item.cls.__mro__:
                if base is Metric or method not in base.__dict__:
                    continue
                fn = base.__dict__[method]
                try:
                    path = inspect.getsourcefile(fn)
                except TypeError:
                    continue
                if path is None:
                    continue
                rel = os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
                qual = getattr(fn, "__qualname__", f"{base.__name__}.{method}")
                roots.setdefault(rel, {})[qual] = (
                    f"Metric contract entry ({item.name}.{method} via _wrap_update/compute_from)"
                )
                break
    return roots, skipped


def analyze(
    target: str,
    baseline_path: Optional[str] = None,
    introspect: bool = True,
    repo_root: Optional[str] = None,
    device: Any = "cuda",
) -> Report:
    """Run tmlint over ``target`` (package dir or single file). The introspection
    tier builds every metric class on ``device`` and raises where that device is
    a card that is not present."""
    t0 = time.perf_counter()
    report = Report()
    repo_root = repo_root or _find_repo_root(target)

    files = load_package(target, repo_root)
    package = PackageModel(files)
    report.parse_errors = dict(package.errors)

    if introspect:
        roots, skipped = _introspection_roots(repo_root, device)
        report.skipped_classes.update(skipped)
        package.inject_roots(roots)
    package.propagate()

    for module, info, _reason in package.reachable_functions():
        report.findings.extend(run_trace_rules(module, info))
    # retrace hazards live at host-side call sites INTO a step: scan everything
    for module in package.modules.values():
        for info in module.functions.values():
            report.findings.extend(run_retrace_rules(module, info))

    if introspect:
        from metrics_tpu_torch.analysis.contract import run_contract_rules

        contract_findings, _ = run_contract_rules(repo_root, device)
        # only report classes that live inside the analyzed tree
        analyzed = set(files)
        report.findings.extend(f for f in contract_findings if f.path in analyzed)

    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))

    if baseline_path is None:
        baseline_path = baseline_mod.default_baseline_path(repo_root)
    if baseline_path is not None:
        from metrics_tpu_torch.analysis.findings import LINT_RULES

        # the waiver file is shared with the card's crosscheck and tmrace: a lint
        # run must not report their waivers as stale
        waivers = baseline_mod.scope_waivers(baseline_mod.load_baseline(baseline_path), LINT_RULES)
        report.new_findings, report.unused_waivers = baseline_mod.apply_baseline(
            report.findings, waivers
        )
    else:
        report.new_findings = list(report.findings)

    report.stats = {
        "files": len(files),
        "functions": sum(len(m.functions) for m in package.modules.values()),
        "trace_reachable": len(package.reachable),
        "findings": len(report.findings),
        "waived": len(report.waived),
        "new": len(report.new_findings),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    return report
