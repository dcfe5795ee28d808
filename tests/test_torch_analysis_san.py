"""tmsan's abstract tier and cost budget of metrics_tpu_torch (``analysis/san/``) against the
JAX package's ``analysis/san/``, on the CPU (fake ``cpu`` tensors: this torch build cannot
make fake ``cuda`` tensors of host data).

- Each rule fixture of ``tests/unittests/analysis/test_tmsan.py`` has a torch twin that
  fires the same rule, traced on fake tensors as the runner traces, and a clean twin that
  stays silent; an unclassified trace failure is a skip, not a finding.
- ``compare_costs`` gives the JAX breaches and notes on the same dicts; a budget stamped
  by another torch or device gives notes, not findings.
- Under ``FakeTensorMode`` with fake ``cuda`` ids, ``bincount``, ``bincount_weighted``,
  ``bincount_batched``, the scan, ``greedy_match`` and ``pair_counts`` return fake outputs
  of the kernels' shapes with no ``_build.load`` and no launch counted.
- The port is clean against its baseline under ``run_san(device="cpu")``: every budgeted
  class's update and compute traced, each skip with its reason, no hand kernel launched;
  a seeded ``.item()`` in an update is a TMS-CALLBACK at its class; the caches a trace
  passes through keep no fake tensor.
- The CLI in subprocesses loads neither ``jax`` nor ``metrics_tpu``: ``--san --device cpu``
  exits 0 on the port, 1 with TMS-CALLBACK on a copy of the port with a traced ``.item()``,
  2 on usage errors.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from metrics_tpu.analysis.san import costs as jax_costs
from metrics_tpu_torch import _build
from metrics_tpu_torch.analysis.findings import SAN_RULES, explain
from metrics_tpu_torch.analysis.san import costs as costs_mod
from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings
from metrics_tpu_torch.analysis.san.dispatch_rules import TraceAnchor, findings_from_facts, upcast_findings
from metrics_tpu_torch.analysis.san.runner import _fake, _fake_mode, _trace, crosscheck_tiers, run_san
from metrics_tpu_torch.ops import greedy_match, histogram, kendall, segment
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOTS = [str(pathlib.Path(__file__).resolve().parent)]  # this file's frames are the "package"
ANCHOR = TraceAnchor(path="metrics_tpu_torch/fake.py", line=1, symbol="Fake.update")
SUBPROCESS_TIMEOUT_S = 300


def _outcome(fn, *args, wide=False):
    """``fn`` traced on fake CPU tensors of ``args``' shapes, as the runner traces."""
    return _trace(fn, _fake_mode(), ROOTS, str(REPO), wide, make_args=lambda: tuple(_fake(a) for a in args))


def _rules(fn, *args, wide=False):
    outcome = _outcome(fn, *args, wide=wide)
    assert outcome.facts is not None, outcome.skip
    return sorted({f.rule for f in findings_from_facts(outcome.facts, ANCHOR, "canon")})


X = torch.zeros(8)


# ------------------------------------------------------------------- per-rule twins


def _item(x):
    return x.sum().item()


def _float(x):
    return float(x.sum()) * x


def test_callback_rule_fires_on_a_host_read():
    assert _rules(_item, X) == ["TMS-CALLBACK"]


def test_callback_rule_fires_on_a_python_float():
    assert "TMS-CALLBACK" in _rules(_float, X)


def test_callback_rule_silent_on_pure_graph():
    assert _rules(lambda x: (x * 2).sum(), X) == []


def test_f64_rule_fires_on_a_widening():
    assert "TMS-F64" in _rules(lambda x: x.to(torch.float64).sum(), X)


def test_f64_rule_silent_when_the_inputs_hold_float64():
    # a trace whose inputs are float64 already widens nothing
    assert _rules(lambda x: (x * 2).sum(), X.double(), wide=True) == []
    assert _rules(lambda x: x.sum(), X) == []


def test_upcast_rule_compares_state_dtypes():
    ins = {"total": torch.zeros((), dtype=torch.bfloat16), "count": torch.zeros((), dtype=torch.int32)}
    outs = {"total": torch.zeros((), dtype=torch.float32), "count": torch.zeros((), dtype=torch.int32)}
    found = upcast_findings(ins, outs, ANCHOR, "canon:bf16")
    assert [f.rule for f in found] == ["TMS-UPCAST"] and "total" in found[0].message
    assert upcast_findings(ins, dict(ins), ANCHOR, "canon:bf16") == []


def _baked(x):
    table = torch.tensor(np.arange(64 * 1024, dtype=np.float32))  # 256 KiB made from host data
    return x.sum() + table[:8].sum()


def test_bigconst_rule_fires_on_a_baked_table():
    assert "TMS-BIGCONST" in _rules(_baked, X)


def test_bigconst_rule_silent_on_small_consts():
    assert _rules(lambda x: x.sum() + torch.tensor(np.arange(16, dtype=np.float32)).sum(), X) == []


def _all_reduce(x):
    torch.distributed.all_reduce(x)
    return x


def test_collective_rule_fires_on_a_collective():
    assert "TMS-COLLECTIVE" in _rules(_all_reduce, X)
    assert not torch.distributed.is_initialized()  # the watch put torch.distributed back


def test_collective_rule_silent_without_one():
    assert _rules(lambda x: x * 2, X) == []


def test_dynshape_classified_trace_failure():
    outcome = _outcome(lambda x: x[x > 0].sum(), X)
    assert outcome.error is not None and outcome.out is None
    assert type(outcome.error).__name__ == "DynamicOutputShapeException"
    assert outcome.where[0].endswith("test_torch_analysis_san.py")


def test_unclassified_trace_failure_is_a_skip_not_a_finding():
    def weird(x):
        raise RuntimeError("unrelated breakage")

    outcome = _outcome(weird, X)
    assert outcome.error is None and outcome.skip.startswith("trace failed: RuntimeError")


def test_a_data_dependent_read_ends_the_trace_as_a_callback():
    outcome = _outcome(lambda x: x * 2 if bool((x > 0).any()) else x, X)
    assert outcome.error is None and outcome.out is None
    assert [f.rule for f in findings_from_facts(outcome.facts, ANCHOR, "canon")] == ["TMS-CALLBACK"]


def test_crosscheck_twins():
    from metrics_tpu_torch.analysis.findings import Finding

    callbacks = [("aten::_local_scalar_dense", "metrics_tpu_torch/some/mod.py", 42, "helper")]
    assert [f.rule for f in lintgap_findings(callbacks, [])] == ["TMS-LINTGAP"]
    covering = Finding("TM-HOSTSYNC", "metrics_tpu_torch/some/mod.py", 41, 0, "helper", "", waived=True)
    assert lintgap_findings(callbacks, [covering]) == []
    key = ("TM-HOSTSYNC", "metrics_tpu_torch/some/mod.py", "helper")
    finding = Finding("TM-HOSTSYNC", key[1], 10, 0, "helper", "")
    stale, status = corroborate_waivers({key: "r"}, [finding], footprint=set(), callbacks=[])
    assert stale == [] and "corroborated-by-absence" in status[":".join(key)]
    stale, _ = corroborate_waivers({key: "r"}, [finding], footprint={(key[1], 10)}, callbacks=[])
    assert [f.rule for f in stale] == ["TMS-STALE-WAIVER"]


def test_the_tiers_crosscheck_lists_each_exception_with_its_reason():
    callbacks = [("aten::_local_scalar_dense", "p/a.py", 3, "f"), ("aten::_local_scalar_dense", "p/a.py", 9, "g"),
                 ("aten::_local_scalar_dense", "p/b.py", 1, "h")]
    synced = [("sync", "p/a.py", 3, "f"), ("sync", "p/c.py", 7, "k")]
    got = crosscheck_tiers(callbacks, synced, card_footprint={("p/a.py", 3), ("p/a.py", 9)})
    assert got["agree"] == [("p/a.py", 3)]
    reasons = {(p, ln): why for p, ln, why in got["exceptions"]}
    assert set(reasons) == {("p/a.py", 9), ("p/b.py", 1), ("p/c.py", 7)}
    assert "without a sync" in reasons[("p/a.py", 9)] and "in no traced step" in reasons[("p/b.py", 1)]
    assert "no host read" in reasons[("p/c.py", 7)]


def test_cases_for_and_inner_spec_read_the_canonical_table():
    """The JAX resolution order on the one table: a class by name or family prefix, the
    two sizes; a wrapped metric's spec by its class name; no spec, no cases."""
    from metrics_tpu_torch import MulticlassAccuracy
    from metrics_tpu_torch.analysis.san.abstract_inputs import SIZES, cases_for, inner_spec

    cases = cases_for("MulticlassAccuracy", object())
    assert set(cases) == set(SIZES) == {"small", "canon"}
    preds, target = cases["canon"][0].args
    assert tuple(preds.shape) == (64, 5) and preds.dtype == torch.float32 and target.dtype == torch.int32
    assert tuple(cases["small"][0].args[0].shape) == (8, 5)
    assert cases_for("NoSuchMetric", object()) is None
    (args, kwargs), = inner_spec(MulticlassAccuracy(num_classes=5, device="cpu"), 8)
    assert args[0].shape == (8, 5) and kwargs == {}


def test_san_rules_explainable():
    assert set(SAN_RULES) == {"TMS-CALLBACK", "TMS-F64", "TMS-UPCAST", "TMS-BIGCONST", "TMS-COLLECTIVE",
                              "TMS-DYNSHAPE", "TMS-LINTGAP", "TMS-STALE-WAIVER", "TMS-BUDGET"}
    for rule in SAN_RULES:
        text = explain(rule)
        assert rule in text and "Waiving" in text


# ----------------------------------------------------------------------- budget

STAMP = {"torch": "2.99", "cuda": "13.0", "device": "NVIDIA H100 80GB HBM3"}
CASES = {
    "breach": ({"M.update[canon]": {"flops": 200.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}},
               {"M.update[canon]": {"flops": 100.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}}),
    "missing": ({"New.update[canon]": {"flops": 1.0, "bytes_accessed": 1.0, "peak_bytes": 1.0}},
                {"M.update[canon]": {"flops": 100.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}}),
    "within": ({"M.update[canon]": {"flops": 110.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}},
               {"M.update[canon]": {"flops": 100.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}}),
    "improved": ({"M.update[canon]": {"flops": 10.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}},
                 {"M.update[canon]": {"flops": 100.0, "bytes_accessed": 100.0, "peak_bytes": 10.0}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_costs_gives_the_jax_breaches_and_notes(case):
    import jax

    current, entries = CASES[case]
    want, want_notes = jax_costs.compare_costs(
        current, {"jax": jax.__version__, "backend": jax.default_backend(), "entries": entries}, anchors={})
    got, notes = costs_mod.compare_costs(current, {**STAMP, "entries": entries}, anchors={}, running=STAMP)
    assert [(f.rule, f.symbol) for f in got] == [(f.rule, f.symbol) for f in want]
    assert notes == want_notes
    for cur, ref in zip(current.values(), entries.values()):
        assert costs_mod._breaches(cur, ref) == jax_costs._breaches(cur, ref)
    assert costs_mod.COST_KEYS == jax_costs.COST_KEYS and costs_mod.BUDGET_TOLERANCE == jax_costs.BUDGET_TOLERANCE


def test_a_budget_of_another_stamp_gives_notes_not_findings():
    current, entries = CASES["breach"]
    findings, notes = costs_mod.compare_costs(current, {**STAMP, "entries": entries}, anchors={},
                                              running={**STAMP, "torch": "2.13.0+cpu"})
    assert findings == [] and any("version-skew" in n for n in notes)
    assert any("but running" in n for n in notes)


def test_costs_are_measured_from_the_fake_trace():
    def measured(fn, counter):
        got = _trace(fn, _fake_mode(), ROOTS, str(REPO), True, extra_mode=counter, footprint=False,
                     make_args=lambda: (_fake(torch.zeros(4, 8)), _fake(torch.zeros(8, 2))))
        return got.facts

    costs = costs_mod.measure_entry(measured, torch.mm)
    assert costs == {"flops": 2.0 * 4 * 8 * 2, "bytes_accessed": float(4 * (32 + 16 + 8)), "peak_bytes": 32.0}


# --------------------------------------------------- the kernel wrappers on fake tensors


def test_wrappers_on_fake_cuda_launch_nothing(monkeypatch):
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name))
    wrappers = (histogram.histogram_cuda, histogram.histogram_batched_cuda, segment.segment_scan_cuda,
                greedy_match.greedy_match_cuda, kendall.kendall_pairs_cuda)
    before = [w.launches for w in wrappers]
    with FakeTensorMode():
        ids = torch.empty(64, dtype=torch.int32, device="cuda")
        out = [histogram.bincount(ids, 11), histogram.bincount_weighted(ids, torch.empty(64, device="cuda"), 7),
               histogram.bincount(torch.empty(64, dtype=torch.int64, device="cuda"), 11),
               histogram.bincount_batched(torch.empty(4, 16, dtype=torch.int32, device="cuda"), None, 5)]
        lanes = torch.empty(64, dtype=torch.int32, device="cuda")
        out += segment.segment_multi_scan([lanes, lanes], torch.empty(64, dtype=torch.bool, device="cuda"),
                                          ops=["sum", "min"])
        out += greedy_match.greedy_match(
            torch.empty(3, 5, 4, device="cuda"), torch.empty(3, 5, device="cuda"), torch.empty(3, 4, device="cuda"),
            torch.empty(3, 5, dtype=torch.bool, device="cuda"), torch.empty(3, 4, dtype=torch.bool, device="cuda"),
            torch.empty(10, device="cuda"), torch.empty(4, 2, device="cuda"))
        out += [kendall.pair_counts(torch.empty(64, 3, device="cuda"), torch.empty(64, 3, device="cuda"))]
    assert all(isinstance(t, FakeTensor) and t.device.type == "cuda" for t in out)
    assert [tuple(t.shape) for t in out] == [(11,), (7,), (11,), (4, 5), (64,), (64,), (3, 4, 10, 5), (3, 4, 10, 5),
                                             (3, 4), (3, 4)]
    assert [t.dtype for t in out[:4]] == [torch.int32, torch.float32, torch.int32, torch.int32]
    assert loads == [] and [w.launches for w in wrappers] == before


# ----------------------------------------------------------------- the port itself


@pytest.fixture(scope="module")
def port_report():
    wrappers = (histogram.histogram_cuda, histogram.histogram_batched_cuda, segment.segment_scan_cuda,
                greedy_match.greedy_match_cuda, kendall.kendall_pairs_cuda)
    before = [w.launches for w in wrappers]
    report = run_san(str(REPO / "metrics_tpu_torch"), device="cpu")
    assert [w.launches for w in wrappers] == before
    return report


def test_the_port_is_clean_against_its_baseline(port_report):
    assert port_report.lint.new_findings == [] and port_report.lint.unused_waivers == []
    assert port_report.new_findings == [], "\n".join(f.format() for f in port_report.new_findings)
    assert port_report.unused_waivers == []
    assert all(f.waive_reason for f in port_report.waived)
    assert not any(s.startswith("STALE") for s in port_report.waiver_status.values())


def test_every_budgeted_class_is_traced_update_and_compute(port_report):
    s = port_report.stats
    assert s["canon_cases"] >= 107 and s["classes_traced"] >= 100
    assert all(reason for reason in port_report.skipped.values())
    assert not any(r.startswith(("update[", "compute[", "[")) for r in port_report.skipped.values()), \
        port_report.skipped
    # the hand kernels are nodes of the traces: their custom ops, never a launch
    assert {"metrics_tpu_torch::bincount", "metrics_tpu_torch::segment_scan"} <= set(port_report.kernel_ops)
    assert port_report.costs and all(set(c) == set(costs_mod.COST_KEYS) for c in port_report.costs.values())
    # the card's budget is stamped otherwise: notes, never a finding here
    assert not any(f.rule == "TMS-BUDGET" for f in port_report.findings)


def test_the_deliberate_float64_sites_are_waived_each_with_its_reason(port_report):
    waived = {(f.rule, f.path) for f in port_report.waived}
    for path in ("functional/audio/sdr.py", "functional/regression/spearman.py", "image/inception.py",
                 "sketches/quantile.py"):
        assert ("TMS-F64", "metrics_tpu_torch/" + path) in waived


def test_traces_leave_no_fake_tensor_in_a_cache(port_report):
    from metrics_tpu_torch.functional.audio import pit
    from metrics_tpu_torch.wrappers import bootstrapping

    assert not any(isinstance(t, FakeTensor) for t in pit._ps_device_cache.values())
    assert not any(isinstance(t, FakeTensor) for t in bootstrapping._POISSON_CDF.values())
    assert not isinstance(bootstrapping.poisson_cdf(), FakeTensor)


def test_a_seeded_item_in_an_update_is_a_callback(monkeypatch):
    import metrics_tpu_torch.regression.mse as mse_mod

    original = mse_mod._mean_squared_error_update

    def smuggled(preds, target, *args, **kwargs):
        out = original(preds, target, *args, **kwargs)
        out[0].sum().item()
        return out

    monkeypatch.setattr(mse_mod, "_mean_squared_error_update", smuggled)
    from metrics_tpu_torch.analysis.san.abstract_inputs import cases_for
    from metrics_tpu_torch.analysis.san.runner import trace_metric

    metric = mse_mod.MeanSquaredError(device="cpu")
    got = trace_metric(metric, cases_for("MeanSquaredError", metric), str(REPO), [str(REPO / "metrics_tpu_torch")],
                       torch.device("cpu"), with_costs=False)
    hits = {(f.rule, f.symbol) for f in got["findings"]}
    assert hits == {("TMS-CALLBACK", "MeanSquaredError.update")}, [f.format() for f in got["findings"]]
    assert got["callbacks"] and all(c[1] == "metrics_tpu_torch/regression/mse.py" for c in got["callbacks"])


# ----------------------------------------------------------------------- CLI


def _cli(*args, cwd, pythonpath):
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
    env = {**os.environ, "PYTHONPATH": str(pythonpath)}
    result = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, env=env, cwd=str(cwd),
                            timeout=SUBPROCESS_TIMEOUT_S)
    line = next((ln for ln in result.stdout.splitlines() if ln.startswith("PROBE ")), None)
    assert line is not None, result.stdout + result.stderr
    import json

    info = json.loads(line[len("PROBE "):])
    return info["rc"], result.stdout, result.stderr, info["loaded"]


def test_cli_san_on_the_port_exits_0_and_on_a_seeded_copy_1(tmp_path):
    rc, out, err, loaded = _cli("--san", "--device", "cpu", "--no-costs", cwd=REPO, pythonpath=REPO)
    assert rc == 0 and loaded == [], out + err
    assert "0 new" in out and "canonical update cases" in out
    copy = tmp_path / "checkout"
    shutil.copytree(REPO / "metrics_tpu_torch", copy / "metrics_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.json"))
    shutil.copy(REPO / "metrics_tpu_torch" / "analysis" / "tmlint_baseline.json",
                copy / "metrics_tpu_torch" / "analysis" / "tmlint_baseline.json")
    mse = copy / "metrics_tpu_torch" / "regression" / "mse.py"
    line = "        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)\n"
    source = mse.read_text()
    assert line in source
    mse.write_text(source.replace(line, line + "        getattr(sum_squared_error.sum(), 'it' + 'em')()\n"))
    rc, out, err, loaded = _cli("--san", "--device", "cpu", "--no-costs", "--no-introspect", cwd=copy,
                                pythonpath=copy)
    assert rc == 1 and "TMS-CALLBACK" in out and loaded == [], out + err


def test_cli_san_usage_errors_exit_2():
    assert _cli("--san", "--race", cwd=REPO, pythonpath=REPO)[0] == 2
    assert _cli("--write-costs", cwd=REPO, pythonpath=REPO)[0] == 2
    assert _cli("--no-costs", "--own", cwd=REPO, pythonpath=REPO)[0] == 2
