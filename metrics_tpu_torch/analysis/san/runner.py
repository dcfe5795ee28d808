"""The card tier: host syncs caught on the card, crosschecked against tmlint.

Counterpart of ``metrics_tpu/analysis/san/runner.py``'s crosscheck. Where the JAX
package traces every registered metric into a jaxpr and reads its host-callback
equations, the port asks the card. For each case of
:func:`~metrics_tpu_torch.obs.canon.budget_cases` (every budgeted class, its
canonical inputs on the card) :func:`collect_card_evidence` runs

1. one warm eager update (its one-time set-up: kernel builds, lazy states);
2. one update inside ``utils/checks.py:tracing()`` — a traced step, where
   ``_is_concrete`` is False as in a capture — under
   ``torch.cuda.set_sync_debug_mode("warn")``, which makes every synchronising
   CUDA call (a device-to-host read, a pageable host-to-device copy, a
   data-dependent size) warn. Each warning is put down to the innermost frame
   of the port that made the call (``synced``), and ``sys.monitoring`` line
   events record every line of the port that ran (``footprint``).

:func:`run_card` runs tmlint (``analyze``, introspecting on the same device),
then the crosscheck (``san/crosscheck.py``): a synced line that no TM-HOSTSYNC
finding covers is a TMS-LINTGAP; a TM-HOSTSYNC waiver whose line ran without a
sync is a TMS-STALE-WAIVER. The sync debug mode is restored afterwards.

The tier needs a card: on a machine without one it raises. The JAX tiers that
have no counterpart here yet (abstract traces, the cost budget) are listed in
``metrics_tpu_torch/analysis/__init__.py``.
"""
import os
import sys
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis import baseline as baseline_mod
from metrics_tpu_torch.analysis.findings import SAN_RULES, Finding
from metrics_tpu_torch.analysis.runner import PACKAGE, Report, _find_repo_root, analyze

#: the text of the warning ``torch.cuda.set_sync_debug_mode("warn")`` raises
SYNC_WARNING = "called a synchronizing CUDA operation"
#: files of the analyzer itself are never evidence
_SELF_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Case = Tuple[str, Callable[[], Any], Tuple[Any, ...], Dict[str, Any]]


@dataclass
class CardEvidence:
    """What the traced updates did on the card."""

    #: ``(what, path, line, function)`` of every synchronising call, innermost port frame
    synced: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: every ``(path, line)`` of the port that ran inside a traced update
    footprint: Set[Tuple[str, int]] = field(default_factory=set)
    #: case key -> synced ``(path, line)`` of that case
    by_case: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    #: case key -> reason it gave no evidence (an update that raised)
    skipped: Dict[str, str] = field(default_factory=dict)
    seconds: float = 0.0


@dataclass
class CardReport:
    """The lint run, the card's evidence and the crosscheck's findings."""

    lint: Optional[Report] = None
    evidence: CardEvidence = field(default_factory=CardEvidence)
    findings: List[Finding] = field(default_factory=list)  # card tier, waived included
    new_findings: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, str, str]] = field(default_factory=list)
    waiver_status: Dict[str, str] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        lint_new = self.lint.new_findings if self.lint is not None else []
        return 1 if (self.new_findings or lint_new) else 0


def _obs_inc(name: str, value: float = 1) -> None:
    from metrics_tpu_torch.obs import registry as _obs

    if _obs._ENABLED:
        _obs.REGISTRY.inc("san", name, value)


def _require_card(device: Any) -> None:
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the card tier reads synchronising calls on a CUDA device (got {device!r},"
            f" cuda available: {torch.cuda.is_available()}); it has no CPU mode"
        )


def _under(roots: Sequence[str], path: str) -> bool:
    """Is ``path`` a file of one of ``roots`` (and not of the analyzer itself)?"""
    absp = os.path.abspath(path)
    return not absp.startswith(_SELF_DIR + os.sep) and any(absp.startswith(r + os.sep) for r in roots)


@contextmanager
def line_footprint(roots: Sequence[str], repo_root: str, into: Set[Tuple[str, int]]) -> Iterator[None]:
    """Record into ``into`` every ``(repo-relative path, line)`` of a file under
    ``roots`` that runs in the body (``sys.monitoring`` line events, Python 3.12+)."""
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id for the line footprint")
    rel_of: Dict[str, Optional[str]] = {}

    def on_line(code: Any, line: int) -> Any:
        path = code.co_filename
        rel = rel_of.get(path, "")
        if rel == "":
            rel = rel_of[path] = (os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
                                  if _under(roots, path) else None)
        if rel is None:
            return mon.DISABLE
        into.add((rel, line))
        return None

    mon.use_tool_id(tool, "metrics_tpu_torch.analysis.san")
    try:
        mon.register_callback(tool, mon.events.LINE, on_line)
        mon.set_events(tool, mon.events.LINE)
        yield
    finally:
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
        mon.restart_events()


@contextmanager
def sync_record(roots: Sequence[str], repo_root: str, into: List[Tuple[str, str, int, str]]) -> Iterator[None]:
    """Record into ``into`` the innermost frame under ``roots`` of every synchronising CUDA call
    in the body: ``torch.cuda.set_sync_debug_mode("warn")``, its warnings caught with
    ``warnings.catch_warnings(record=True)`` and ``simplefilter("always")``; the
    previous debug mode is restored."""
    import torch

    def innermost() -> Optional[Tuple[str, int, str]]:
        frame = sys._getframe(1)
        while frame is not None:
            if _under(roots, frame.f_code.co_filename):
                rel = os.path.relpath(os.path.abspath(frame.f_code.co_filename), repo_root).replace(os.sep, "/")
                return rel, frame.f_lineno, frame.f_code.co_name
            frame = frame.f_back
        return None

    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def hook(message, category, filename, lineno, file=None, line=None):  # noqa: ANN001
            caught.append(warnings.WarningMessage(message, category, filename, lineno, file, line))
            if SYNC_WARNING in str(message):
                where = innermost()
                into.append(("sync", *where) if where else ("sync", "", 0, ""))

        warnings.showwarning = hook  # catch_warnings puts the original back
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(before)


def collect_card_evidence(
    device: Any = "cuda",
    seed: int = 0,
    cases: Optional[Sequence[Case]] = None,
    repo_root: Optional[str] = None,
    roots: Optional[Sequence[str]] = None,
) -> CardEvidence:
    """One warm eager update, then one traced update under the sync debug mode, of
    every case (default: every ``budget_cases(device, seed)`` case). Frames and lines
    count where their file lies under ``roots`` (default: the port's package)."""
    import torch

    from metrics_tpu_torch.obs.canon import budget_cases
    from metrics_tpu_torch.utils.checks import tracing

    _require_card(device)
    t0 = time.perf_counter()
    package_dir = os.path.dirname(_SELF_DIR)
    repo_root = repo_root or os.path.dirname(package_dir)
    roots = [os.path.abspath(r) for r in (roots or [package_dir])]
    if cases is None:
        cases, _ = budget_cases(device, seed)
    evidence = CardEvidence()
    for key, make, args, kwargs in cases:
        try:
            metric = make()
            metric.update(*args, **kwargs)  # warm: builds, lazy states, first-call set-up
            torch.cuda.synchronize()
            synced: List[Tuple[str, str, int, str]] = []
            with sync_record(roots, repo_root, synced), line_footprint(roots, repo_root, evidence.footprint), tracing():
                metric.update(*args, **kwargs)
            torch.cuda.synchronize()
        except Exception as err:  # noqa: BLE001 - a case that raises is recorded, the sweep goes on
            evidence.skipped[key] = f"{type(err).__name__}: {str(err).splitlines()[0][:200] if str(err) else ''}"
            continue
        evidence.synced.extend(synced)
        evidence.by_case[key] = sorted({(p, ln) for _, p, ln, _ in synced if p})
    evidence.seconds = time.perf_counter() - t0
    return evidence


def run_card(
    target: str = PACKAGE,
    baseline_path: Optional[str] = None,
    repo_root: Optional[str] = None,
    device: Any = "cuda",
    seed: int = 0,
    cases: Optional[Sequence[Case]] = None,
    lint: Optional[Report] = None,
    roots: Optional[Sequence[str]] = None,
) -> CardReport:
    """tmlint on ``target`` (introspecting on ``device``; or the given ``lint``
    report), the card's evidence over ``cases`` (every budgeted class by default)
    with frames under ``roots``, and the crosscheck between them, against the
    baseline."""
    from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings

    _require_card(device)
    t0 = time.perf_counter()
    report = CardReport()
    repo_root = repo_root or _find_repo_root(target)
    report.lint = lint if lint is not None else analyze(
        target, baseline_path=baseline_path, repo_root=repo_root, device=device)
    report.evidence = collect_card_evidence(device, seed, cases, repo_root, roots)

    lint_findings = report.lint.findings
    report.findings.extend(lintgap_findings(report.evidence.synced, lint_findings))
    if baseline_path is None:
        baseline_path = baseline_mod.default_baseline_path(repo_root)
    waivers = baseline_mod.load_baseline(baseline_path) if baseline_path else {}
    stale, report.waiver_status = corroborate_waivers(
        waivers, lint_findings, report.evidence.footprint, report.evidence.synced)
    report.findings.extend(stale)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    report.new_findings, report.unused_waivers = baseline_mod.apply_baseline(
        report.findings, baseline_mod.scope_waivers(waivers, SAN_RULES))
    # the JAX tier's counters (``san.*``), as Rule.counter names them
    _obs_inc("traced", len(report.evidence.by_case))
    _obs_inc("findings", len(report.findings))
    _obs_inc("lintgaps", sum(f.rule == "TMS-LINTGAP" for f in report.findings))
    _obs_inc("stale_waivers", sum(f.rule == "TMS-STALE-WAIVER" for f in report.findings))
    report.stats = {
        "cases": len(report.evidence.by_case),
        "skipped": len(report.evidence.skipped),
        "synced_lines": len({(p, ln) for _, p, ln, _ in report.evidence.synced if p}),
        "footprint_lines": len(report.evidence.footprint),
        "findings": len(report.findings),
        "waived": len(report.waived),
        "new": len(report.new_findings),
        "card_seconds": round(report.evidence.seconds, 3),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    return report
