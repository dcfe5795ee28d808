"""tmsan orchestration: the abstract tier (traces on fake tensors, the cost budget) and
the card tier (host syncs caught on the card), each crosschecked against tmlint.

Counterpart of ``metrics_tpu/analysis/san/runner.py``.

**The abstract tier** (:func:`run_san`), the JAX package's jaxpr tier: every budgeted
class of :func:`~metrics_tpu_torch.analysis.san.abstract_inputs.budget_classes` (the
table of ``obs/canon.py:budget_cases``) has its ``local_update`` and then its
``compute_from`` on the post-update state traced inside ``utils/checks.py:tracing()``
on fake tensors (``FakeTensorMode``: nothing executes, nothing is allocated, no hand
kernel launches; each wrapper's custom op gives its shapes), on the device the caller
gives: fake ``cuda`` on the card, fake ``cpu`` in the CPU tests. A
``TorchDispatchMode`` records every op (``dispatch_rules.py``) and ``sys.monitoring``
line events the footprint. Everything degrades per entry: a constructor failure or a
missing input spec is a recorded skip; a ``DynamicOutputShapeException`` is a
TMS-DYNSHAPE finding and a ``DataDependentOutputException`` a TMS-CALLBACK one (ground
truth the AST tier claims cannot happen); any other trace failure is a skip with its
reason. Host-side classes are skipped as in the JAX package. At the canonical size the
update is traced again with bf16 states and inputs (TMS-UPCAST) and once more for the
cost budget (``costs.py``). The ``ops/`` entry points are traced alike.

**The card tier** (:func:`run_card`): for each case of
:func:`~metrics_tpu_torch.obs.canon.budget_cases` (every budgeted class, its canonical
inputs on the card) :func:`collect_card_evidence` runs

1. one warm eager update (its one-time set-up: kernel builds, lazy states);
2. one update inside ``tracing()`` — a traced step, where ``_is_concrete`` is False as
   in a capture — under ``torch.cuda.set_sync_debug_mode("warn")``, which makes every
   synchronising CUDA call (a device-to-host read, a pageable host-to-device copy, a
   data-dependent size) warn, and then, for a class whose compute the engines run as a
   traced step (not ``_host_side_compute``; the fused ``forward`` captures it), one
   ``compute_from`` alike, of the state one pure update from the defaults gives (the
   state a fused ``forward`` computes from). Each warning is put down to the
   innermost frame of the port that made the call (``synced``), and ``sys.monitoring``
   line events record every line of the port that ran (``footprint``).

Each tier runs tmlint (``analyze``) and the crosscheck (``san/crosscheck.py``): a
host read or a synced line that no TM-HOSTSYNC finding covers is a TMS-LINTGAP; a
TM-HOSTSYNC waiver whose line ran without one is a TMS-STALE-WAIVER.
:func:`crosscheck_tiers` holds the two tiers against each other: every TMS-CALLBACK
line of the abstract tier that runs in a traced step on the card is a line the card
saw synchronise, and the other way round, each exception with its reason.

The card tier needs a card: on a machine without one it raises. The abstract tier runs
anywhere, on ``device="cpu"``.
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
from metrics_tpu_torch.analysis.san import costs as costs_mod
from metrics_tpu_torch.analysis.san.dispatch_rules import (
    DispatchRecorder,
    GraphFacts,
    TraceAnchor,
    findings_from_facts,
    innermost_frame,
    traceback_frame,
    upcast_findings,
    wide_dtype_in,
)

#: the text of the warning ``torch.cuda.set_sync_debug_mode("warn")`` raises
SYNC_WARNING = "called a synchronizing CUDA operation"
#: files of the analyzer itself are never evidence
_SELF_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Case = Tuple[str, Callable[[], Any], Tuple[Any, ...], Dict[str, Any]]
#: the card tier's rules: the crosscheck against tmlint
CARD_RULES: Tuple[str, ...] = ("TMS-LINTGAP", "TMS-STALE-WAIVER")


@dataclass
class CardEvidence:
    """What the traced updates did on the card."""

    #: ``(what, path, line, function)`` of every synchronising call, innermost port frame
    synced: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: every ``(path, line)`` of the port that ran inside a traced update
    footprint: Set[Tuple[str, int]] = field(default_factory=set)
    #: case key -> synced ``(path, line)`` of that case's traced update, and of its compute
    by_case: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    compute_by_case: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    #: case key -> the kernel launches of its compute part (the pure update that gives the
    #: compute's state, and the traced compute), by wrapper
    compute_launches: Dict[str, Dict[Any, int]] = field(default_factory=dict)
    #: case keys whose compute was traced (the class's compute is a traced step)
    computes: List[str] = field(default_factory=list)
    #: case key -> reason its compute gave no evidence (a compute that raised)
    compute_skipped: Dict[str, str] = field(default_factory=dict)
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
    computes: bool = True,
) -> CardEvidence:
    """One warm eager update, then one traced update and (with ``computes``, for a class
    that is not ``_host_side_compute``) one traced ``compute_from`` of a pure update's
    state under the sync debug mode, of every case (default: every ``budget_cases(device, seed)``
    case). Frames and lines count where their file lies under ``roots`` (default: the
    port's package). The compute's kernel launches are kept apart by wrapper
    (``compute_launches``) and counted as usual."""
    import torch

    from metrics_tpu_torch import _build
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
            compute_synced: List[Tuple[str, str, int, str]] = []
            with sync_record(roots, repo_root, synced), line_footprint(roots, repo_root, evidence.footprint), tracing():
                metric.update(*args, **kwargs)
            torch.cuda.synchronize()
            if computes and not getattr(type(metric), "_host_side_compute", False):
                with _build.capture_tally() as tally:  # counted apart, then as usual below
                    try:
                        # the state a fused ``forward`` computes from: one pure update from the defaults
                        state = metric.local_update(metric.init_state(), *args, **kwargs)
                        torch.cuda.synchronize()
                        with sync_record(roots, repo_root, compute_synced), line_footprint(
                                roots, repo_root, evidence.footprint), tracing():
                            metric.compute_from(state)
                        torch.cuda.synchronize()
                        evidence.computes.append(key)
                    except Exception as err:  # noqa: BLE001 - a compute that raises is recorded apart
                        evidence.compute_skipped[key] = f"{type(err).__name__}: {_first_line(err)[:200]}"
                for wrapper, n in tally.items():
                    _build.note_launch(wrapper, n)
                evidence.compute_launches[key] = dict(tally)
        except Exception as err:  # noqa: BLE001 - a case that raises is recorded, the sweep goes on
            evidence.skipped[key] = f"{type(err).__name__}: {str(err).splitlines()[0][:200] if str(err) else ''}"
            continue
        evidence.synced.extend(synced + compute_synced)
        evidence.by_case[key] = sorted({(p, ln) for _, p, ln, _ in synced if p})
        evidence.compute_by_case[key] = sorted({(p, ln) for _, p, ln, _ in compute_synced if p})
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
    computes: bool = True,
) -> CardReport:
    """tmlint on ``target`` (introspecting on ``device``; or the given ``lint``
    report), the card's evidence over ``cases`` (every budgeted class by default;
    their traced computes with ``computes``) with frames under ``roots``, and the
    crosscheck between them, against the baseline."""
    from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings

    _require_card(device)
    t0 = time.perf_counter()
    report = CardReport()
    repo_root = repo_root or _find_repo_root(target)
    report.lint = lint if lint is not None else analyze(
        target, baseline_path=baseline_path, repo_root=repo_root, device=device)
    report.evidence = collect_card_evidence(device, seed, cases, repo_root, roots, computes)

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
        report.findings, baseline_mod.scope_waivers(waivers, CARD_RULES))
    # the JAX tier's counters (``san.*``), as Rule.counter names them
    _obs_inc("traced", len(report.evidence.by_case))
    _obs_inc("findings", len(report.findings))
    _obs_inc("lintgaps", sum(f.rule == "TMS-LINTGAP" for f in report.findings))
    _obs_inc("stale_waivers", sum(f.rule == "TMS-STALE-WAIVER" for f in report.findings))
    report.stats = {
        "cases": len(report.evidence.by_case),
        "computes": len(report.evidence.computes),
        "computes_skipped": len(report.evidence.compute_skipped),
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


# ------------------------------------------------------------------ abstract tier

#: trace-failure types that are findings, matched by exception class NAME so that torch
#: version drift cannot break the gate: a data-dependent size (TMS-DYNSHAPE), and a host
#: read fake tensors cannot answer (TMS-CALLBACK)
_DYNSHAPE_ERRORS = ("DynamicOutputShapeException",)
_CALLBACK_ERRORS = ("DataDependentOutputException",)
#: the ``torch.distributed`` collectives the trace watches for (TMS-COLLECTIVE)
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "broadcast_object_list", "all_to_all", "all_to_all_single",
                "barrier", "reduce", "gather", "scatter")


@dataclass
class SanReport:
    """The abstract tier's report: tmlint's run, the traced sweep and the cost budget."""

    lint: Optional[Report] = None
    findings: List[Finding] = field(default_factory=list)  # san tier, waived included
    new_findings: List[Finding] = field(default_factory=list)
    unused_waivers: List[Tuple[str, str, str]] = field(default_factory=list)
    #: class or ops entry -> traced entry count (update/compute x sizes x cases)
    traced: Dict[str, int] = field(default_factory=dict)
    skipped: Dict[str, str] = field(default_factory=dict)
    costs: Dict[str, Dict[str, float]] = field(default_factory=dict)
    budget_notes: List[str] = field(default_factory=list)
    waiver_status: Dict[str, str] = field(default_factory=dict)
    #: ``(op, path, line, function)`` of every host read the traces saw
    callbacks: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: ``(op, path, line, function, onto_card)`` of every tensor made from host data
    transfers: List[Tuple[str, str, int, str, bool]] = field(default_factory=list)
    #: ``(op, path, line, function)`` of every checked ``torch.linalg`` op (a sync on the card)
    checks: List[Tuple[str, str, int, str]] = field(default_factory=list)

    def host_work(self, onto_card: bool = False) -> List[Tuple[str, str, int, str]]:
        """The host reads, the checked ``torch.linalg`` ops and the tensors made from host
        data (with ``onto_card``, only those copied onto the card) the traces saw."""
        return self.callbacks + self.checks + [t[:4] for t in self.transfers if t[4] or not onto_card]
    #: every ``(path, line)`` of the package that ran in a trace
    footprint: Set[Tuple[str, int]] = field(default_factory=set)
    #: the package's custom ops (hand kernels) the traces dispatched, by op
    kernel_ops: Dict[str, int] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def exit_code(self) -> int:
        lint_new = self.lint.new_findings if self.lint is not None else []
        return 1 if (self.new_findings or lint_new) else 0


class _CollectiveReached(Exception):
    """A ``torch.distributed`` collective reached inside a trace (the trace ends there)."""


@contextmanager
def _collective_watch(facts: GraphFacts, roots: Sequence[str], repo_root: str) -> Iterator[None]:
    """Inside the body ``torch.distributed`` reports an initialized process group of one
    rank, and each collective records its call site into ``facts`` and ends the trace: a
    collective that an update or compute reaches only with a group shows as well, while
    ``Metric.sync``'s gather returns its input at one rank, as it does for real."""
    import torch.distributed as dist

    def reached(name: str) -> Callable:
        def call(*args: Any, **kwargs: Any) -> Any:
            path, line, _ = innermost_frame(roots, repo_root, sys._getframe(1))
            facts.collectives.append((f"torch.distributed.{name}", "", path, line))
            raise _CollectiveReached(name)
        return call

    patched = {name: reached(name) for name in _COLLECTIVES if hasattr(dist, name)}
    patched.update(is_available=lambda: True, is_initialized=lambda: True, get_world_size=lambda group=None: 1,
                   get_rank=lambda group=None: 0)
    saved = {name: getattr(dist, name) for name in patched if hasattr(dist, name)}
    for name, fn in patched.items():
        setattr(dist, name, fn)
    try:
        yield
    finally:
        for name in patched:
            if name in saved:
                setattr(dist, name, saved[name])
            else:
                delattr(dist, name)


@dataclass
class _TraceOutcome:
    facts: Optional[GraphFacts] = None
    out: Any = None
    error: Optional[BaseException] = None
    where: Tuple[str, int, str] = ("", 0, "")
    skip: str = ""


def _first_line(err: BaseException) -> str:
    return str(err).splitlines()[0][:300] if str(err) else ""


def _trace(fn: Callable[..., Any], mode: Any, roots: Sequence[str], repo_root: str, wide_inputs: bool,
           extra_mode: Any = None, footprint: bool = True,
           make_args: Optional[Callable[[], Tuple[Any, ...]]] = None) -> _TraceOutcome:
    """``fn(*make_args())`` under ``mode`` (a ``FakeTensorMode``), the recorder, the
    collective watch and ``tracing()``; the arguments are made in ``mode`` before the
    recorder starts (inputs, not the trace's work). Classified failures become findings,
    others a skip."""
    from metrics_tpu_torch.utils.checks import tracing

    facts = GraphFacts()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with mode:
                args = make_args() if make_args is not None else ()
                with DispatchRecorder(facts, roots, repo_root, wide_inputs), \
                        extra_mode if extra_mode is not None else _nothing(), \
                        line_footprint(roots, repo_root, facts.footprint) if footprint else _nothing(), \
                        _collective_watch(facts, roots, repo_root), tracing():
                    out = fn(*args)
    except _CollectiveReached:
        return _TraceOutcome(facts=facts)
    except Exception as err:  # noqa: BLE001 - every failure is data, not a crash
        name = type(err).__name__
        where = traceback_frame(roots, repo_root, err.__traceback__)
        if name in _DYNSHAPE_ERRORS:
            return _TraceOutcome(facts=facts, error=err, where=where)
        if name in _CALLBACK_ERRORS:
            if not any((p, ln) == where[:2] for _, p, ln, _ in facts.callbacks):
                facts.callbacks.append((name, *where))
            return _TraceOutcome(facts=facts)
        return _TraceOutcome(skip=f"trace failed: {name}: {_first_line(err)}")
    return _TraceOutcome(facts=facts, out=out)


@contextmanager
def _nothing() -> Iterator[None]:
    yield


def _fake(x: Any, device: Any = None) -> Any:
    """A fake tensor of ``x``'s shape, strides and dtype on ``device`` (default: its own),
    made under the active ``FakeTensorMode``; non-tensors as they are."""
    import torch

    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                               device=x.device if device is None else device)


def _bf16(tree: Any) -> Any:
    import torch
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda t: t.to(torch.bfloat16) if isinstance(t, torch.Tensor) and t.dtype in (torch.float32, torch.float64)
        else t, tree)


def _has_float_state(state: Any) -> bool:
    import torch
    from torch.utils import _pytree as pytree

    return any(isinstance(t, torch.Tensor) and t.is_floating_point() for t in pytree.tree_leaves(state))


def _dynshape_finding(anchor: TraceAnchor, case: str, err: BaseException, where: Tuple[str, int, str]) -> Finding:
    at = f" at {where[0]}:{where[1]}" if where[0] else ""
    return Finding(
        rule="TMS-DYNSHAPE", path=where[0] or anchor.path, line=where[1] or anchor.line, col=0, symbol=anchor.symbol,
        message=(f"abstract trace of {anchor.symbol} [{case}] failed{at} with {type(err).__name__}: {_first_line(err)}"
                 " — ground truth that the body is not trace-safe; tmlint's AST tier should have predicted this"),
    )


def _method_anchor(cls: type, method: str, repo_root: str) -> Optional[TraceAnchor]:
    import inspect

    from metrics_tpu_torch.core.metric import Metric

    for base in cls.__mro__:
        if base is Metric or method not in base.__dict__:
            continue
        try:
            path = inspect.getsourcefile(base.__dict__[method])
            _, line = inspect.getsourcelines(base.__dict__[method])
        except (OSError, TypeError):
            return None
        if path is None:
            return None
        rel = os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
        return None if rel.startswith("..") else TraceAnchor(path=rel, line=line, symbol=f"{cls.__name__}.{method}")
    return None


def _fn_anchor(fn: Callable, key: str, repo_root: str) -> TraceAnchor:
    import inspect

    try:
        path = inspect.getsourcefile(fn)
        _, line = inspect.getsourcelines(fn)
        rel = os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
    except (OSError, TypeError):
        rel, line = "", 0
    return TraceAnchor(path=rel, line=line, symbol=key)


def _fake_mode() -> Any:
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_metric(metric: Any, cases: Dict[str, List[Any]], repo_root: str, roots: Sequence[str], device: Any,
                 with_costs: bool = True) -> Dict[str, Any]:
    """The abstract traces of one metric over its cases by size tag: ``{"entries": n,
    "findings": [...], "skips": [...], "callbacks": [...], "footprint": set, "costs": {key:
    costs}, "anchors": {key: (path, line)}, "kernel_ops": {op: n}}``."""
    import torch

    cls = type(metric)
    name = cls.__name__
    up_anchor = _method_anchor(cls, "update", repo_root) or TraceAnchor("", 0, f"{name}.update")
    cp_anchor = _method_anchor(cls, "compute", repo_root) or TraceAnchor("", 0, f"{name}.compute")
    out: Dict[str, Any] = {"entries": 0, "canon_updates": 0, "findings": [], "skips": [], "callbacks": [],
                           "transfers": [], "checks": [],
                           "footprint": set(), "costs": {}, "anchors": {}, "kernel_ops": {}}
    with torch.no_grad():
        real_state = metric.init_state()
    wide_state = wide_dtype_in(real_state)

    def take(facts: GraphFacts, anchor: TraceAnchor, tag: str) -> None:
        out["entries"] += 1
        out["footprint"] |= facts.footprint
        out["callbacks"].extend(facts.callbacks)
        out["transfers"].extend(facts.transfers)
        out["checks"].extend(facts.checks)
        out["findings"].extend(findings_from_facts(facts, anchor, tag))
        for op, n in facts.kernel_ops.items():
            out["kernel_ops"][op] = out["kernel_ops"].get(op, 0) + n

    for size, size_cases in cases.items():
        for case in size_cases:
            wide = wide_state or wide_dtype_in(case.args)
            mode = _fake_mode()

            def inputs(case=case):
                return (metric.init_state(), *(_fake(a, device) for a in case.args))

            def update(state, *args, case=case):
                return metric.local_update(state, *args, **case.kwargs)

            outcome = _trace(update, mode, roots, repo_root, wide, make_args=inputs)
            if outcome.error is not None:
                out["findings"].append(_dynshape_finding(up_anchor, case.tag, outcome.error, outcome.where))
                _obs_inc("trace_failures")
                continue
            if outcome.skip:
                out["skips"].append(f"update[{case.tag}]: {outcome.skip}")
                continue
            take(outcome.facts, up_anchor, case.tag)
            out["canon_updates"] += size == "canon"
            if outcome.out is not None and not getattr(cls, "_host_side_compute", False):
                # compute on the POST-update state (cat states have rows now), in the same fake mode
                c_outcome = _trace(metric.compute_from, mode, roots, repo_root, wide,
                                   make_args=lambda s=outcome.out: (s,))
                if c_outcome.error is not None:
                    out["findings"].append(_dynshape_finding(cp_anchor, case.tag, c_outcome.error, c_outcome.where))
                    _obs_inc("trace_failures")
                elif c_outcome.skip:
                    out["skips"].append(f"compute[{case.tag}]: {c_outcome.skip}")
                else:
                    take(c_outcome.facts, cp_anchor, case.tag)
            if size != "canon":
                continue
            if _has_float_state(real_state):
                # the bf16 variant: does update keep a narrow state dtype?
                mode = _fake_mode()

                def narrow_inputs(case=case):
                    return (_bf16(metric.init_state()), *(_bf16(_fake(a, device)) for a in case.args))

                def narrow(state, *args, case=case):
                    return state, metric.local_update(state, *args, **case.kwargs)

                bf = _trace(narrow, mode, roots, repo_root, True, footprint=False, make_args=narrow_inputs)
                if bf.out is not None:  # bf16 support is opportunistic
                    out["findings"].extend(upcast_findings(bf.out[0], bf.out[1], up_anchor, f"{case.tag}:bf16"))
            if with_costs:
                key = f"{name}.update[{case.tag}]"

                def measured(fn, counter, inputs=inputs):
                    got = _trace(fn, _fake_mode(), roots, repo_root, True, extra_mode=counter, footprint=False,
                                 make_args=inputs)
                    return got.facts if got.out is not None else None

                costs = costs_mod.measure_entry(measured, update)
                if costs is not None:
                    out["costs"][key] = costs
                    out["anchors"][key] = (up_anchor.path, up_anchor.line)
    return out


def run_san(
    target: str = PACKAGE,
    baseline_path: Optional[str] = None,
    costs_path: Optional[str] = None,
    repo_root: Optional[str] = None,
    with_costs: bool = True,
    with_lint: bool = True,
    device: Any = "cuda",
    seed: int = 0,
    lint: Optional[Report] = None,
    introspect: bool = True,
) -> SanReport:
    """The abstract tier over the budgeted classes and the ops entry points on fake
    ``device`` tensors, tmlint (introspecting on ``device``; or the given ``lint``), the
    crosscheck and the cost budget, against the baseline (see the module docstring)."""
    import torch

    from metrics_tpu_torch.analysis.san.abstract_inputs import budget_classes, ops_cases
    from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings

    t0 = time.perf_counter()
    report = SanReport()
    repo_root = repo_root or _find_repo_root(target)
    roots = [os.path.join(os.path.abspath(repo_root), PACKAGE)]
    if lint is not None:
        report.lint = lint
    elif with_lint:
        report.lint = analyze(target, baseline_path=baseline_path, repo_root=repo_root, device=device,
                              introspect=introspect)
    device = torch.device(device)

    cost_current: Dict[str, Dict[str, float]] = {}
    cost_anchors: Dict[str, Tuple[str, int]] = {}
    n_traces = 0
    t_trace = time.perf_counter()
    classes, skipped = budget_classes(device, seed)
    report.skipped.update(skipped)
    canon_cases = 0
    for name, entry in sorted(classes.items()):
        try:
            metric = entry.make()
        except Exception as err:  # noqa: BLE001 - a class that cannot be built is a recorded skip
            report.skipped[name] = f"construction failed: {type(err).__name__}: {_first_line(err)}"
            continue
        got = trace_metric(metric, entry.sizes, repo_root, roots, device, with_costs)
        canon_cases += got["canon_updates"]
        n_traces += got["entries"]
        report.findings.extend(got["findings"])
        report.callbacks.extend(got["callbacks"])
        report.transfers.extend(got["transfers"])
        report.checks.extend(got["checks"])
        report.footprint |= got["footprint"]
        cost_current.update(got["costs"])
        cost_anchors.update(got["anchors"])
        for op, n in got["kernel_ops"].items():
            report.kernel_ops[op] = report.kernel_ops.get(op, 0) + n
        if got["entries"]:
            report.traced[name] = got["entries"]
            _obs_inc("traced")
        if got["skips"]:
            report.skipped[name] = got["skips"][0]
        elif not got["entries"] and not got["findings"]:
            report.skipped[name] = "no entry traced"

    for key, (fn, sizes) in sorted(ops_cases().items()):
        anchor = _fn_anchor(fn, key, repo_root)
        entries = 0
        for size, cases in sizes.items():
            for case in cases:
                def inputs(case=case):
                    return tuple(_fake(a, device) for a in case.args)

                def call(*args, case=case):
                    return fn(*args, **case.kwargs)

                outcome = _trace(call, _fake_mode(), roots, repo_root, wide_dtype_in(case.args), make_args=inputs)
                if outcome.error is not None:
                    report.findings.append(_dynshape_finding(anchor, case.tag, outcome.error, outcome.where))
                    _obs_inc("trace_failures")
                    continue
                if outcome.skip:
                    report.skipped.setdefault(key, f"[{case.tag}]: {outcome.skip}")
                    continue
                entries += 1
                report.footprint |= outcome.facts.footprint
                report.callbacks.extend(outcome.facts.callbacks)
                report.transfers.extend(outcome.facts.transfers)
                report.checks.extend(outcome.facts.checks)
                report.findings.extend(findings_from_facts(outcome.facts, anchor, case.tag))
                if with_costs and size == "canon":
                    def measured(f, counter, inputs=inputs):
                        got = _trace(f, _fake_mode(), roots, repo_root, True, extra_mode=counter, footprint=False,
                                     make_args=inputs)
                        return got.facts if got.out is not None else None

                    costs = costs_mod.measure_entry(measured, call)
                    if costs is not None:
                        cost_current[f"{key}[{case.tag}]"] = costs
                        cost_anchors[f"{key}[{case.tag}]"] = (anchor.path, anchor.line)
        n_traces += entries
        if entries:
            report.traced[key] = entries
            _obs_inc("traced")
    t_trace = time.perf_counter() - t_trace

    lint_findings = report.lint.findings if report.lint is not None else []
    report.findings.extend(lintgap_findings(report.callbacks, lint_findings))
    if baseline_path is None:
        baseline_path = baseline_mod.default_baseline_path(repo_root)
    waivers = baseline_mod.load_baseline(baseline_path) if baseline_path else {}
    # a waived host transfer or checked linalg op that ran in a trace is host work seen, as a host read is
    stale, report.waiver_status = corroborate_waivers(waivers, lint_findings, report.footprint, report.host_work())
    report.findings.extend(stale)

    report.costs = cost_current
    if with_costs:
        budget_path = costs_path or costs_mod.default_costs_path(repo_root)
        if budget_path is not None:
            budget = costs_mod.load_costs(budget_path)
            budget_findings, notes = costs_mod.compare_costs(cost_current, budget, cost_anchors,
                                                             costs_mod.stamp(device))
            report.findings.extend(budget_findings)
            report.budget_notes.extend(notes)
            _obs_inc("budget_breaches", len(budget_findings))
        else:
            report.budget_notes.append(
                f"no {costs_mod.COSTS_FILENAME} in the package's analysis/: write it on the card with --write-costs")

    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    report.new_findings, report.unused_waivers = baseline_mod.apply_baseline(
        report.findings, baseline_mod.scope_waivers(waivers, SAN_RULES))
    _obs_inc("findings", len(report.findings))
    for rule, counter in (("TMS-CALLBACK", "callbacks"), ("TMS-F64", "f64"), ("TMS-UPCAST", "upcasts"),
                          ("TMS-BIGCONST", "bigconsts"), ("TMS-COLLECTIVE", "collectives"),
                          ("TMS-LINTGAP", "lintgaps"), ("TMS-STALE-WAIVER", "stale_waivers")):
        n = sum(f.rule == rule for f in report.findings)
        if n:
            _obs_inc(counter, n)
    report.stats = {
        "classes_traced": sum(1 for k in report.traced if not k.startswith("ops.")),
        "canon_cases": canon_cases,
        "entries_traced": n_traces,
        "skipped": len(report.skipped),
        "findings": len(report.findings),
        "waived": len(report.waived),
        "new": len(report.new_findings),
        "cost_entries": len(cost_current),
        "kernel_ops": sum(report.kernel_ops.values()),
        "trace_seconds": round(t_trace, 3),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    return report


def crosscheck_tiers(
    callbacks: Sequence[Tuple[str, str, int, str]],
    synced: Sequence[Tuple[str, str, int, str]],
    card_footprint: Set[Tuple[str, int]],
) -> Dict[str, Any]:
    """The abstract tier's host reads against the card's synchronising lines. A
    TMS-CALLBACK line that ran in a traced step on the card must have synchronised
    there, and a line that synchronised on the card must be a TMS-CALLBACK line; each
    exception carries its reason. Returns ``{"agree": [...], "exceptions": [(path,
    line, reason), ...]}``."""
    abstract = {(p, ln) for _, p, ln, _ in callbacks if p}
    card = {(p, ln) for _, p, ln, _ in synced if p}
    agree = sorted(abstract & card)
    exceptions: List[Tuple[str, int, str]] = []
    for p, ln in sorted(abstract - card):
        if (p, ln) not in card_footprint:
            exceptions.append((p, ln, "a host read of the abstract tier on a line that ran in no traced step on"
                                      " the card"))
        else:
            exceptions.append((p, ln, "ran in a traced step on the card without a sync: a host read of a CPU"
                                      " tensor or of a Python value"))
    for p, ln in sorted(card - abstract):
        exceptions.append((p, ln, "synchronised on the card with no host read in the abstract tier: a"
                                  " synchronising copy or allocation the fake trace does not see"))
    return {"agree": agree, "exceptions": exceptions}
