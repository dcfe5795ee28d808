"""tmrace of metrics_tpu_torch (``analysis/race/``) against the JAX package's, on the CPU.

- Both race analyzers over one copy of ``metrics_tpu_torch/`` (this checkout's) give the
  same findings ``(rule, path, line, symbol)`` and the same role map.
- Both give the same findings and role map on every seeded fixture of
  ``tests/unittests/analysis/test_tmrace.py`` (the AB/BA cycle, the unlocked
  read-modify-write, the handler, the leak and their clean twins), read from that file.
- The port's tmrace is clean against the port's baseline, each of its waivers with a
  reason of its own; a device sync under a lock is torch's (``synchronize``), where the
  JAX model names ``block_until_ready`` and ``jax.device_get``.
"""
import ast
import pathlib
import shutil
import textwrap

import pytest

from metrics_tpu.analysis.race import run_race as jax_run_race
from metrics_tpu_torch.analysis.race import run_race as port_run_race
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TESTS = REPO / "tests" / "unittests" / "analysis" / "test_tmrace.py"
PORT_BASELINE = REPO / "metrics_tpu_torch" / "analysis" / "tmlint_baseline.json"


def _fixtures() -> dict:
    """{test name: source} of every ``_race_snippet(tmp_path, "source")`` in the JAX tmrace
    tests, and of every ``src.replace(a, b)`` variant of a test's ``src`` template."""
    out = {}
    for node in ast.parse(JAX_TESTS.read_text()).body:
        if not isinstance(node, ast.FunctionDef):
            continue
        template = None
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1 and isinstance(sub.targets[0], ast.Name)
                    and sub.targets[0].id == "src" and isinstance(sub.value, ast.Constant)):
                template = sub.value.value
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            if (isinstance(call.func, ast.Name) and call.func.id == "_race_snippet" and len(call.args) > 1
                    and isinstance(call.args[1], ast.Constant)):
                out[node.name] = call.args[1].value
            if (template is not None and isinstance(call.func, ast.Attribute) and call.func.attr == "replace"
                    and isinstance(call.func.value, ast.Name) and call.func.value.id == "src"
                    and all(isinstance(a, ast.Constant) for a in call.args)):
                old, new = (a.value for a in call.args)
                out[f"{node.name}[{new}]"] = template.replace(old, new)
    return out


FIXTURES = _fixtures()


def _keys(report) -> list:
    return sorted((f.rule, f.path, f.line, f.symbol) for f in report.findings)


def test_fixtures_cover_every_rule():
    assert len(FIXTURES) >= 15
    names = " ".join(FIXTURES)
    for kind in ("unlocked", "order", "hold_host", "handler", "leak", "locked_by", "thread_role"):
        assert kind in names


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_seeded_fixtures_match_the_jax_package(tmp_path, name):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(FIXTURES[name]))
    want = jax_run_race(str(path), repo_root=str(tmp_path), baseline_path=None)
    got = port_run_race(str(path), repo_root=str(tmp_path), baseline_path=None)
    assert got.parse_errors == want.parse_errors == {}
    assert _keys(got) == _keys(want)
    assert got.roles == want.roles
    assert [f.message for f in sorted(got.findings, key=lambda f: f.line)] == [
        f.message for f in sorted(want.findings, key=lambda f: f.line)]
    # the port's own annotation vocabulary reads the same
    port_path = tmp_path / "port" / "mod.py"
    port_path.parent.mkdir()
    port_path.write_text(path.read_text().replace("metrics_tpu.utils.concurrency", "metrics_tpu_torch.utils.concurrency"))
    assert _keys(port_run_race(str(port_path), repo_root=str(port_path.parent), baseline_path=None)) == _keys(want)


def test_both_analyzers_agree_over_a_copy_of_the_port(tmp_path):
    shutil.copytree(REPO / "metrics_tpu_torch", tmp_path / "metrics_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    target = str(tmp_path / "metrics_tpu_torch")
    want = jax_run_race(target, repo_root=str(tmp_path), baseline_path=None)
    got = port_run_race(target, repo_root=str(tmp_path), baseline_path=None)
    assert _keys(got) == _keys(want)
    assert got.roles == want.roles
    assert got.stats["locks"] == want.stats["locks"] and got.stats["threads"] == want.stats["threads"]
    assert {f.rule for f in got.findings} == {"TMR-HOLD-HOST", "TMR-UNLOCKED"}


def test_the_port_is_clean_against_its_baseline():
    report = port_run_race(str(REPO / "metrics_tpu_torch"), baseline_path=str(PORT_BASELINE))
    assert report.new_findings == [], [f.format() for f in report.new_findings]
    assert report.unused_waivers == []
    reasons = [f.waive_reason for f in report.waived]
    assert len(reasons) == 4 and len(set(reasons)) == 4
    assert report.roles.get("tm-ingest", 0) > 0 and report.roles.get("user", 0) > 0


def test_a_device_sync_under_a_lock_is_torchs(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent("""
        import threading
        import torch

        _LOCK = threading.Lock()

        def drain(event):
            with _LOCK:
                torch.cuda.synchronize()
                event.synchronize()
        """))
    got = port_run_race(str(path), repo_root=str(tmp_path), baseline_path=None)
    assert [(f.rule, f.line) for f in got.findings] == [("TMR-HOLD-HOST", 9), ("TMR-HOLD-HOST", 10)]
    assert all("device sync" in f.message for f in got.findings)
    assert jax_run_race(str(path), repo_root=str(tmp_path), baseline_path=None).findings == []
