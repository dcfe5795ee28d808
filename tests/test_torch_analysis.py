"""The static analyzer of metrics_tpu_torch (``analysis/``: tmlint, its baseline, the
card tier's crosscheck, the CLI) against the JAX package's ``analysis/``, on the CPU.

- Each tmlint fixture of ``tests/unittests/analysis/test_tmlint.py``, rewritten in torch
  with the same line layout, gives the same ``(rule, line, symbol)`` set in the port as the
  JAX fixture gives in the JAX package (the trace-safety and retrace fixtures through
  ``analyze``, the state-contract fixtures through ``class_findings`` on live instances).
- Both ``load_baseline``s read the root ``tmlint_baseline.json`` the same way; the port's
  own baseline gives every waiver a reason of its own.
- ``lintgap_findings`` and ``corroborate_waivers`` give equal output on the same seeded
  evidence (every branch: a gap, a cover by line and by function, a waiver stale,
  corroborated by absence and by presence, and unused).
- The port's package is clean against its baseline with the introspection tier on the CPU,
  with trace-reachable functions, and holds no TM-HOSTSYNC at the host-to-device copies and
  host checks the card's crosscheck found (repaired); the introspection tier on ``cuda``
  raises without a card. The retrieval input check is skipped in a traced step.
- The CLI in subprocesses: it loads neither ``jax`` nor ``metrics_tpu``, exits 0 on the
  port (``--device cpu``, ``--race``), 1 with the rule ID on seeded-bad torch packages
  (traced ``.item()``, ``torch.nonzero``, an AB/BA lock cycle), 2 on usage errors; ``--card``
  raises without a card.
"""
import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from metrics_tpu.analysis import analyze as jax_analyze
from metrics_tpu.analysis import baseline as jax_baseline
from metrics_tpu.analysis.contract import class_findings as jax_class_findings
from metrics_tpu.analysis.findings import Finding as JaxFinding
from metrics_tpu.analysis.registry import IntrospectedClass as JaxIntrospected
from metrics_tpu.analysis.san import crosscheck as jax_crosscheck
from metrics_tpu_torch.analysis import baseline as port_baseline
from metrics_tpu_torch.analysis import explain
from metrics_tpu_torch.analysis.contract import class_findings as port_class_findings
from metrics_tpu_torch.analysis.findings import LINT_RULES, OWN_RULES, RACE_RULES, RULES, SAN_RULES
from metrics_tpu_torch.analysis.findings import Finding as PortFinding
from metrics_tpu_torch.analysis.registry import IntrospectedClass as PortIntrospected
from metrics_tpu_torch.analysis.runner import analyze as port_analyze
from metrics_tpu_torch.analysis.san import crosscheck as port_crosscheck
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs, tracing
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TESTS = REPO / "tests" / "unittests" / "analysis" / "test_tmlint.py"
PORT_BASELINE = REPO / "metrics_tpu_torch" / "analysis" / "tmlint_baseline.json"
SUBPROCESS_TIMEOUT_S = 120


def _jax_fixtures(helper: str, position: int) -> dict:
    """{test name: source} of every ``helper(..., "source")`` call in the JAX tmlint tests."""
    out = {}
    for node in ast.parse(JAX_TESTS.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            for call in ast.walk(node):
                if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name) and call.func.id == helper
                        and len(call.args) > position and isinstance(call.args[position], ast.Constant)):
                    out[node.name] = call.args[position].value
    return out


# ---------------------------------------------------------- trace-rule fixtures
# the JAX fixtures rewritten in torch, line for line

TORCH_SNIPPETS = {
    "test_hostsync_bad": """
        import torch
        import torch.nn.functional as F
        import numpy as np

        @torch.compile
        def kernel(x):
            total = x.sum().item()
            arr = np.asarray(x)
            return torch.as_tensor(total) + arr.sum()
        """,
    "test_hostsync_clean_guarded_and_static": """
        import torch
        import torch.nn.functional as F
        import numpy as np
        from metrics_tpu_torch.utils.checks import _is_concrete

        @torch.func.vmap
        def kernel(x):
            n = x.shape[0]
            m = int(n) * 2                      # static shape arithmetic
            pad = np.zeros(3, np.float32)       # static-arg numpy constant
            if _is_concrete(x):
                host = float(x.sum())           # eager-only side of the guard
                return torch.as_tensor(host + m)
            return x.sum() + m + pad.sum()
        """,
    "test_hostsync_bad_bare_imports": """
        import torch
        from numpy import asarray, array
        from torch import equal as same

        @torch.compile
        def kernel(x):
            a = asarray(x)
            b = array(x)
            c = same(x, x)
            return a.sum() + b.sum() + x.sum() * c
        """,
    "test_hostsync_clean_bare_imports_static": """
        import torch
        from numpy import asarray, prod, float32

        @torch.compile
        def kernel(x):
            n = prod(x.shape)
            pad = asarray([0.0, 1.0], float32)
            return x.sum() + int(n) + pad.sum()
        """,
    "test_pybranch_bad": """
        import torch
        from torch import Tensor

        @torch.compile
        def kernel(x):
            if torch.any(x > 0):
                return x.sum()
            return -x.sum()
        """,
    "test_pybranch_clean_static_tests": """
        import torch
        from torch import Tensor
        from metrics_tpu_torch.utils.checks import _is_concrete

        @torch.func.vmap
        def kernel(x, flag: bool):
            if torch.is_floating_point(torch.as_tensor(x)):
                x = x * 2
            if flag:
                x = x + 1
            if _is_concrete(x) and bool(torch.any(x > 100)):
                raise ValueError("overflow")
            return x.sum()
        """,
    "test_dynshape_bad": """
        import torch
        from torch import Tensor

        @torch.compile
        def kernel(x):
            u = torch.unique(x)
            pos = x[x > 0]
            return u.sum() + pos.sum()
        """,
    "test_dynshape_clean_with_size": """
        import torch
        from torch import Tensor

        @torch.compile
        def kernel(x):
            u = torch.sort(x).values
            pos = torch.where(x > 0, x, 0.0)
            return u.sum() + pos.sum()
        """,
    "test_retrace_bad": """
        import torch
        from torch import Tensor

        def _kernel(x, scale):
            return x * scale

        _kernel_c = torch.compile(_kernel)

        def apply(x, scale: float):
            return _kernel_c(x, scale)

        def rebuild_every_call(x):
            return torch.compile(lambda v: v * 2)(x)
        """,
    "test_retrace_clean_static_argnames_and_asarray": """
        import torch
        from torch import Tensor

        def _kernel(x, scale, mode):
            return x * scale if mode == "a" else x + scale

        _kernel_c = torch.compile(_kernel, dynamic=True)

        def apply(x, scale: float, mode: str):
            return _kernel_c(x, torch.as_tensor(scale), mode=mode)
        """,
}


def _lint(analyze, directory: pathlib.Path, source: str) -> set:
    directory.mkdir()
    path = directory / "mod.py"
    path.write_text(textwrap.dedent(source))
    report = analyze(str(path), introspect=False, repo_root=str(directory))
    assert report.parse_errors == {}
    return {(f.rule, f.line, f.symbol) for f in report.new_findings}


@pytest.mark.parametrize("name", sorted(TORCH_SNIPPETS))
def test_trace_rule_fixtures_match_the_jax_package(tmp_path, name):
    jax_source = _jax_fixtures("_lint_snippet", 1)[name]
    port_source = TORCH_SNIPPETS[name]
    assert len(textwrap.dedent(port_source).splitlines()) == len(textwrap.dedent(jax_source).splitlines())
    want = _lint(jax_analyze, tmp_path / "jax", jax_source)
    got = _lint(port_analyze, tmp_path / "port", port_source)
    assert got == want
    assert bool(want) == ("bad" in name)  # the bad fixtures fire, the clean ones stay silent


# ------------------------------------------------------- state-contract fixtures

TORCH_CONTRACT = {
    "test_state_unreg_bad": """
        class BadUnreg(Metric):
            full_state_update = False
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
            def update(self, x) -> None:
                self.total = self.total + x.sum()
                self.last_batch_mean = x.mean()
            def compute(self):
                return self.total
        """,
    "test_state_unreg_clean_conditional_registration": """
        class CleanConditional(Metric):
            full_state_update = False
            def __init__(self, binned=False, **kw):
                super().__init__(**kw)
                if binned:
                    self.add_state("confmat", torch.zeros((2, 2)), dist_reduce_fx="sum")
                else:
                    self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
                self.binned = binned
            def update(self, x) -> None:
                if self.binned:
                    self.confmat = self.confmat + 1
                else:
                    self.total = self.total + x.sum()
            def compute(self):
                return self.total if not self.binned else self.confmat
        """,
    "test_reduce_mismatch_bad": """
        def _weird(stack):
            return stack[0]

        class BadReduce(Metric):
            full_state_update = False
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("dense_cat", torch.zeros(3), dist_reduce_fx="cat")
                self.add_state("int_mean", torch.tensor(0), dist_reduce_fx="mean")
                self.add_state("custom", torch.tensor(0.0), dist_reduce_fx=_weird)
            def update(self, x) -> None:
                self.int_mean = self.int_mean + 1
            def compute(self):
                return self.int_mean
        """,
    "test_reduce_mismatch_clean": """
        class CleanReduce(Metric):
            full_state_update = False
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
                self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")
                self.add_state("rows", [], dist_reduce_fx="cat")
                self.add_state("stacked", torch.tensor(0.0), dist_reduce_fx=None)
            def update(self, x) -> None:
                self.total = self.total + x.sum()
            def compute(self):
                return self.total
        """,
    "test_persist_bad": """
        class BadPersist(Metric):
            full_state_update = False
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
                self.running_window = torch.zeros(8)
            def update(self, x) -> None:
                self.total = self.total + x.sum()
            def compute(self):
                return self.total
        """,
    "test_persist_clean_declared_exemptions": """
        class CleanPersist(Metric):
            full_state_update = False
            _update_signature_attrs = ("thresholds",)
            _ckpt_exempt_attrs = ("scratch",)
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
                self.thresholds = torch.linspace(0, 1, 5)
                self.scratch = torch.zeros(4)
            def update(self, x) -> None:
                self.total = self.total + x.sum()
            def compute(self):
                return self.total
        """,
}
JAX_PRELUDE = "import jax.numpy as jnp\nfrom metrics_tpu.core.metric import Metric\n"
PORT_PRELUDE = "import torch\nfrom metrics_tpu_torch.core.metric import Metric\n"


def _contract(directory: pathlib.Path, prelude: str, source: str, module: str, introspected, class_findings,
              **ctor) -> set:
    directory.mkdir()
    path = directory / "fixture.py"
    path.write_text(prelude + textwrap.dedent(source))
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    try:
        spec.loader.exec_module(mod)
        cls = next(v for v in vars(mod).values() if isinstance(v, type) and v.__module__ == module)
        findings = class_findings(introspected(cls.__name__, cls, cls(**ctor)), repo_root=str(directory))
    finally:
        del sys.modules[module]
    return {(f.rule, f.line, f.symbol) for f in findings}


@pytest.mark.parametrize("name", sorted(TORCH_CONTRACT))
def test_state_contract_fixtures_match_the_jax_package(tmp_path, name):
    jax_source = _jax_fixtures("_load_module", 2)[name]
    port_source = TORCH_CONTRACT[name]
    assert len(textwrap.dedent(port_source).splitlines()) == len(textwrap.dedent(jax_source).splitlines())
    tag = name.replace("test_", "")
    want = _contract(tmp_path / "jax", JAX_PRELUDE, jax_source, f"jax_{tag}", JaxIntrospected, jax_class_findings)
    got = _contract(tmp_path / "port", PORT_PRELUDE, port_source, f"port_{tag}", PortIntrospected,
                    port_class_findings, device="cpu")
    assert got == want
    assert bool(want) == ("bad" in name)


# ------------------------------------------------------------------- baseline


def test_both_load_baselines_read_the_root_baseline_alike():
    path = str(REPO / "tmlint_baseline.json")
    assert port_baseline.load_baseline(path) == jax_baseline.load_baseline(path)


def test_written_baselines_agree_and_empty_reasons_are_refused(tmp_path):
    kw = dict(rule="TM-HOSTSYNC", path="pkg/mod.py", line=3, col=0, symbol="f", message="m")
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    assert port_baseline.write_baseline(str(port_path), [PortFinding(**kw)], reason="why") == 1
    jax_baseline.write_baseline(str(jax_path), [JaxFinding(**kw)], reason="why")
    port, jax = json.loads(port_path.read_text()), json.loads(jax_path.read_text())
    assert port["waivers"] == jax["waivers"] and port["version"] == jax["version"]
    assert jax_baseline.load_baseline(str(port_path)) == port_baseline.load_baseline(str(port_path))
    port_baseline.write_baseline(str(port_path), [PortFinding(**kw)], reason="")
    with pytest.raises(ValueError, match="has no reason"):
        port_baseline.load_baseline(str(port_path))


def test_the_ports_baseline_gives_each_waiver_its_own_reason():
    waivers = json.loads(PORT_BASELINE.read_text())["waivers"]
    reasons = [w["reason"] for w in waivers]
    assert waivers and all(reasons) and len(set(reasons)) == len(reasons)
    assert not any("bootstrap" in r for r in reasons)
    assert {w["rule"] for w in waivers} <= set(LINT_RULES) | set(RACE_RULES) | set(SAN_RULES) | set(OWN_RULES)
    assert all(w["path"].startswith("metrics_tpu_torch/") for w in waivers)


def test_rule_tables_partition_and_explain():
    assert set(LINT_RULES) == {"TM-HOSTSYNC", "TM-PYBRANCH", "TM-DYNSHAPE", "TM-RETRACE", "TM-STATE-UNREG",
                               "TM-REDUCE-MISMATCH", "TM-PERSIST"}
    assert set(SAN_RULES) == {"TMS-CALLBACK", "TMS-F64", "TMS-UPCAST", "TMS-BIGCONST", "TMS-COLLECTIVE",
                              "TMS-DYNSHAPE", "TMS-LINTGAP", "TMS-STALE-WAIVER", "TMS-BUDGET"}
    assert set(RACE_RULES) == {"TMR-UNLOCKED", "TMR-ORDER", "TMR-HOLD-HOST", "TMR-HANDLER", "TMR-LEAK"}
    assert set(OWN_RULES) == {"TMO-DONATE-ALIAS", "TMO-USE-AFTER-DONATE", "TMO-DOUBLE-DONATE", "TMO-SNAPSHOT-GAP",
                              "TMO-KEY-GAP", "TMO-ENGINE-DRIFT"}
    assert set(RULES) == set(LINT_RULES) | set(SAN_RULES) | set(RACE_RULES) | set(OWN_RULES)
    from metrics_tpu.analysis.findings import RULES as JAX_RULES

    for rule_id, rule in RULES.items():
        assert rule.family == JAX_RULES[rule_id].family
        text = explain(rule_id)
        assert rule_id in text and rule.runtime_signal in text
    # the obs counters named are the port's (the same names as the JAX package's)
    assert "retrace_signatures" in RULES["TM-RETRACE"].counter
    assert "operation not permitted when stream is capturing" in RULES["TM-HOSTSYNC"].runtime_signal


# ----------------------------------------------------------------- crosscheck


def _evidence(finding_cls):
    findings = [
        finding_cls("TM-HOSTSYNC", "pkg/a.py", 10, 4, "A.update", "m"),
        finding_cls("TM-HOSTSYNC", "pkg/a.py", 40, 4, "helper", "m"),
        finding_cls("TM-HOSTSYNC", "pkg/b.py", 7, 0, "B.compute", "m"),
        finding_cls("TM-HOSTSYNC", "pkg/c.py", 5, 0, "scan", "m"),
        finding_cls("TM-PYBRANCH", "pkg/a.py", 60, 0, "A.update", "m"),
    ]
    callbacks = [
        ("sync", "pkg/a.py", 12, "update"),     # covered by line (within the slack)
        ("sync", "pkg/a.py", 90, "helper"),     # covered by function
        ("sync", "pkg/a.py", 60, "other"),      # a PYBRANCH does not cover: a gap
        ("sync", "pkg/d.py", 3, "loose"),       # a gap
        ("sync", "pkg/d.py", 3, "loose"),       # the same line again: one finding
        ("sync", "", 0, ""),                    # no attribution: skipped
        ("sync", "pkg/b.py", 7, "compute"),     # a waived line that syncs: presence
    ]
    waivers = {
        ("TM-HOSTSYNC", "pkg/a.py", "helper"): "absent",
        ("TM-HOSTSYNC", "pkg/b.py", "B.compute"): "present",
        ("TM-HOSTSYNC", "pkg/c.py", "scan"): "stale",
        ("TM-HOSTSYNC", "pkg/e.py", "gone"): "unused",
        ("TM-PYBRANCH", "pkg/a.py", "A.update"): "not corroborated",
    }
    footprint = {("pkg/b.py", 7), ("pkg/c.py", 5), ("pkg/a.py", 11)}
    return findings, callbacks, waivers, footprint


def test_crosscheck_gives_the_jax_output_on_the_same_evidence():
    j_findings, callbacks, waivers, footprint = _evidence(JaxFinding)
    p_findings, _, _, _ = _evidence(PortFinding)
    want_gaps = jax_crosscheck.lintgap_findings(callbacks, j_findings)
    got_gaps = port_crosscheck.lintgap_findings(callbacks, p_findings)
    assert [vars(f) for f in got_gaps] == [vars(f) for f in want_gaps]
    assert [(f.path, f.line) for f in got_gaps] == [("pkg/a.py", 60), ("pkg/d.py", 3)]
    want_stale, want_status = jax_crosscheck.corroborate_waivers(waivers, j_findings, footprint, callbacks)
    got_stale, got_status = port_crosscheck.corroborate_waivers(waivers, p_findings, footprint, callbacks)
    assert [vars(f) for f in got_stale] == [vars(f) for f in want_stale]
    assert got_status == want_status
    assert [f.symbol for f in got_stale] == ["scan"]
    assert sorted(s.split(" ")[0] for s in got_status.values()) == [
        "STALE:", "corroborated-by-absence", "corroborated-by-presence", "unused"]


# ------------------------------------------------------------ the port itself


@pytest.fixture(scope="module")
def port_report():
    return port_analyze(str(REPO / "metrics_tpu_torch"), baseline_path=str(PORT_BASELINE), device="cpu")


def test_the_port_is_clean_against_its_baseline(port_report):
    assert port_report.parse_errors == {}
    assert port_report.new_findings == [], "\n".join(f.format() for f in port_report.new_findings)
    assert port_report.unused_waivers == []
    assert port_report.stats["trace_reachable"] > 0 and port_report.stats["findings"] > 0
    # the port's own trace entries are seen: the fleet's vmap, the engines' steps, the vmap rules
    import metrics_tpu_torch.analysis.jitmap as jitmap
    from metrics_tpu_torch.analysis.runner import _find_repo_root

    root = _find_repo_root(str(REPO / "metrics_tpu_torch"))
    package = jitmap.PackageModel(jitmap.load_package(str(REPO / "metrics_tpu_torch"), root))
    package.propagate()
    reached = {q for (_, q) in package.reachable}
    for qual in ("routed_new_state.unit", "broadcast_new_state.one", "FusedCollectionUpdate._build.step",
                 "_bincount_vmap", "_segment_scan_vmap"):
        assert qual in reached, qual


REPAIRED = [  # (path, symbol) of the host reads the card's crosscheck found and this port repaired
    ("metrics_tpu_torch/functional/classification/exact_match.py", "_multiclass_exact_match_update"),
    ("metrics_tpu_torch/functional/image/psnr.py", "_psnr_update"),
    ("metrics_tpu_torch/functional/image/psnrb.py", "_psnrb_update"),
    ("metrics_tpu_torch/functional/image/psnrb.py", "_compute_bef.boundaries"),
    ("metrics_tpu_torch/functional/image/ssim.py", "_multiscale_ssim_update"),
    ("metrics_tpu_torch/functional/regression/log_cosh.py", "_log_cosh_error_update"),
    ("metrics_tpu_torch/functional/regression/tweedie_deviance.py", "_tweedie_deviance_score_update"),
    ("metrics_tpu_torch/functional/audio/sdr.py", "_solve"),
    ("metrics_tpu_torch/image/fid.py", "FrechetInceptionDistance.update"),
    ("metrics_tpu_torch/utils/checks.py", "_check_retrieval_inputs"),
    ("metrics_tpu_torch/functional/classification/auroc.py", "_binary_auroc_compute"),
    ("metrics_tpu_torch/ops/clf_curve.py", "binary_auroc_exact"),
    ("metrics_tpu_torch/sketches/quantile.py", "QuantileSketch.compute"),
]


def test_repaired_host_reads_hold_no_finding(port_report):
    flagged = {(f.path, f.symbol) for f in port_report.findings if f.rule == "TM-HOSTSYNC"}
    assert not flagged & set(REPAIRED)
    # the pattern each repair removed is one the AST tier now flags
    assert ("metrics_tpu_torch/functional/audio/pit.py", "_perm_table") in flagged  # the one copy, at a cache miss


def test_host_to_device_rule_flags_the_repaired_patterns(tmp_path):
    source = """
        import numpy as np
        import torch

        @torch.compile
        def kernel(x, betas: tuple, values: np.ndarray):
            n = torch.tensor(x.numel(), device=x.device)
            b = torch.tensor(betas, dtype=x.dtype, device=x.device)
            i = torch.as_tensor(values, device=x.device)
            m = torch.from_numpy(values).to(x.device)
            s = torch.linalg.solve(x, x)
            ok = torch.full((), x.numel(), device=x.device)
            c = torch.as_tensor(x, device=x.device)
            h = torch.tensor(3.0)
            return n + b + i + m + s + ok + c + h
        """
    got = sorted((line, rule) for rule, line, _ in _lint(port_analyze, tmp_path / "p", source))
    assert got == [(7, "TM-HOSTSYNC"), (8, "TM-HOSTSYNC"), (9, "TM-HOSTSYNC"), (10, "TM-HOSTSYNC"),
                   (11, "TM-HOSTSYNC")]


def test_introspection_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda introspection tier runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_analyze(str(REPO / "metrics_tpu_torch" / "core"), device="cuda")


class _HostReads(TorchFunctionMode):
    """Counts the tensor methods that read device values on the host."""

    NAMES = {"item", "tolist", "__bool__", "__int__", "__float__", "numpy"}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.NAMES:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_retrieval_value_checks_are_skipped_in_a_traced_step():
    indexes = torch.tensor([0, 0, -1, 1])
    preds = torch.tensor([0.2, 0.4, 0.6, 0.8])
    target = torch.tensor([0, 1, 1, 0])
    with pytest.raises(ValueError, match="non-negative"):
        _check_retrieval_inputs(indexes, preds, target)
    with tracing(), _HostReads() as mode:  # the JAX check skips tracers alike
        idx, p, t = _check_retrieval_inputs(indexes, preds, target)
    assert mode.reads == [] and idx.dtype == torch.int32 and p.dtype == torch.float32
    from metrics_tpu_torch.retrieval import RetrievalMAP

    metric = RetrievalMAP(device="cpu")
    with tracing(), _HostReads() as mode:
        metric.update(preds, target, indexes=torch.tensor([0, 0, 1, 1]))
    assert mode.reads == []


# ----------------------------------------------------------------------- CLI


def _cli(*args, cwd=None):
    """``python -m metrics_tpu_torch.analysis`` in a subprocess: its exit code, output,
    and whether it loaded jax or metrics_tpu."""
    probe = (
        "import json, runpy, sys\n"
        f"sys.argv = ['metrics_tpu_torch.analysis', *{list(args)!r}]\n"
        "try:\n"
        "    runpy.run_module('metrics_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n"
        "    rc = 0\n"
        "except SystemExit as exit_:\n"
        "    rc = exit_.code\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu')]\n"
        "print('PROBE ' + json.dumps({'rc': rc, 'loaded': loaded}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    result = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, env=env,
                            cwd=cwd or str(REPO), timeout=SUBPROCESS_TIMEOUT_S)
    line = next((ln for ln in result.stdout.splitlines() if ln.startswith("PROBE ")), None)
    assert line is not None, result.stdout + result.stderr
    info = json.loads(line[len("PROBE "):])
    return info["rc"], result.stdout, result.stderr, info["loaded"]


def test_cli_on_the_port_exits_0_and_loads_no_jax():
    rc, out, err, loaded = _cli("--device", "cpu")
    assert rc == 0, out + err
    assert loaded == []
    assert "trace-reachable" in out and "0 new" in out
    rc, out, err, loaded = _cli("--race")
    assert rc == 0 and loaded == [], out + err
    assert "4 waived, 0 new" in out


SEEDED_BAD = {
    "TM-HOSTSYNC": ("mod.py", """
        import torch

        @torch.func.vmap
        def per_row(x):
            return x.sum().item()
        """, ["--no-introspect"]),
    "TM-DYNSHAPE": ("mod.py", """
        import torch

        def update_step(x):
            return torch.nonzero(x)

        steps = torch.compile(update_step)
        """, ["--no-introspect"]),
    "TMR-ORDER": ("mod.py", """
        import threading

        _A = threading.Lock()
        _B = threading.Lock()

        def forward():
            with _A:
                with _B:
                    pass

        def backward():
            with _B:
                with _A:
                    pass
        """, ["--race"]),
}


@pytest.mark.parametrize("rule", sorted(SEEDED_BAD))
def test_cli_exits_1_with_the_rule_on_seeded_bad_packages(tmp_path, rule):
    name, source, flags = SEEDED_BAD[rule]
    pkg = tmp_path / "seeded"
    pkg.mkdir()
    (pkg / name).write_text(textwrap.dedent(source))
    rc, out, err, loaded = _cli(str(pkg), *flags, cwd=str(tmp_path))
    assert rc == 1, out + err
    assert rule in out and loaded == []


def test_cli_usage_explain_json_and_card(tmp_path):
    rc, out, _, _ = _cli("--explain", "TM-HOSTSYNC")
    assert rc == 0 and "TM-HOSTSYNC" in out and "obs counter" in out
    assert _cli("--explain", "TM-NOPE")[0] == 2
    assert _cli("a", "b")[0] == 2
    assert _cli("--select", "TM-NOPE", "--no-introspect")[0] == 2
    pkg = tmp_path / "p"
    pkg.mkdir()
    (pkg / "m.py").write_text("import torch\n@torch.compile\ndef k(x):\n    return float(x)\n")
    rc, out, _, _ = _cli(str(pkg), "--no-introspect", "--json", cwd=str(tmp_path))
    payload = json.loads(out[:out.index("PROBE ")])
    assert rc == 1 and payload["new"][0]["rule"] == "TM-HOSTSYNC"
    if not torch.cuda.is_available():
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        result = subprocess.run([sys.executable, "-m", "metrics_tpu_torch.analysis", "--card"], capture_output=True,
                                text=True, env=env, cwd=str(REPO), timeout=SUBPROCESS_TIMEOUT_S)
        assert result.returncode != 0 and "no CPU mode" in result.stderr


def test_fixture_sources_are_the_jax_tests_own():
    """The JAX fixtures read from the JAX tests cover every fixture rewritten here."""
    assert set(TORCH_SNIPPETS) == set(_jax_fixtures("_lint_snippet", 1))
    assert set(TORCH_CONTRACT) == set(_jax_fixtures("_load_module", 2))
    assert np.all([len(v) > 0 for v in TORCH_SNIPPETS.values()])
