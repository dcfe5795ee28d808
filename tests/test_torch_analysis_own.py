"""tmown of metrics_tpu_torch (``analysis/own/``: buffer ownership over the captured steps)
against the JAX package's ``analysis/own/``, on the CPU.

- Each rule fixture of ``tests/unittests/analysis/test_tmown.py`` (the fourteen rule
  fixtures), rewritten in torch with the same line layout — ``compile_step`` for
  ``jax.jit(..., donate_argnums=...)``, a states list for two donated positions,
  ``is_step_buffer`` for ``is_deleted`` — gives the same ``(rule, line, symbol)`` set in
  the port as the JAX fixture gives in the JAX package; so does the drift pair, with the
  same worksheet divergences and key fields.
- The port is clean against its baseline, sees its four engines with the contract's
  components and key fields, and its worksheet ``analysis/tmown_engine_drift.json`` is in
  sync. The checkpoint restore's clone is the owning copy of a payload view.
- The CLI in subprocesses loads neither ``jax`` nor ``metrics_tpu``: exit 0 on the port,
  1 with the rule on a seeded use after replay and a seeded payload alias, 2 on usage errors.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from metrics_tpu.analysis.own import engine_contract as jax_contract
from metrics_tpu.analysis.own import run_own as jax_run_own
from metrics_tpu.analysis.own.buffer_model import build_model as jax_build_model
from metrics_tpu_torch.analysis.own import engine_contract
from metrics_tpu_torch.analysis.own import run_own
from metrics_tpu_torch.analysis.own.buffer_model import build_model
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TESTS = REPO / "tests" / "unittests" / "analysis" / "test_tmown.py"
PORT_BASELINE = REPO / "metrics_tpu_torch" / "analysis" / "tmlint_baseline.json"
SUBPROCESS_TIMEOUT_S = 120


def _jax_fixtures() -> dict:
    """{test name: source} of every ``_own_snippet(tmp_path, "source")`` call, and the
    module-level engine sources, of the JAX tmown tests."""
    out = {}
    for node in ast.parse(JAX_TESTS.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            for call in ast.walk(node):
                if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name) and call.func.id == "_own_snippet"
                        and len(call.args) > 1 and isinstance(call.args[1], ast.Constant)):
                    out[node.name] = call.args[1].value
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and node.value.args:
            arg = node.value.args[0]
            if isinstance(arg, ast.Constant) and isinstance(node.targets[0], ast.Name):
                out[node.targets[0].id] = arg.value
    return out


# ------------------------------------------------------------------ rule fixtures
# the JAX fixtures rewritten in torch, line for line

TORCH_SNIPPETS = {
    "test_donate_alias_bad_pr16_twin": """
        import numpy as np
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def restore(payload):
            view = np.frombuffer(payload, dtype="float32")
            state = torch.as_tensor(view)
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            out = jitted(state, [])
            return out
        """,
    "test_donate_alias_clean_twin_owned_copy": """
        import numpy as np
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def restore(payload):
            view = np.frombuffer(payload, dtype="float32")
            state = torch.as_tensor(view).clone()
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            out = jitted(state, [])
            return out
        """,
    "test_donate_alias_host_numpy_bad": """
        import numpy as np
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state

        def launch(n):
            state = np.zeros(n, dtype="float32")
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            return jitted(state, [])
        """,
    "test_use_after_donate_bad": """
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def launch(n):
            state = torch.zeros(n)
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            out = jitted(state, [])
            norm = out - state
            return norm
        """,
    "test_use_after_donate_repoint_clean_twin": """
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def launch(n):
            state = torch.zeros(n)
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            state = jitted(state, [])
            norm = state.sum()
            return norm
        """,
    "test_use_after_donate_is_deleted_handler_exempt": """
        import torch
        from metrics_tpu_torch.core.fused import compile_step, is_step_buffer

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def launch(n):
            state = torch.zeros(n)
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            try:
                out = jitted(state, [])
            except RuntimeError:
                if is_step_buffer(state):
                    out = torch.zeros(n)
                else:
                    raise
            return out
        """,
    "test_double_donate_bad": """
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step2(states):
            return [states[0] + states[1], states[1]]

        def launch(x):
            jitted = compile_step(step2, [x, x], [])
            secure_pending_snapshots([x])
            out, aux = jitted([x, x], [])
            return out
        """,
    "test_double_donate_distinct_args_clean_twin": """
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step2(states):
            return [states[0] + states[1], states[1]]

        def launch(x, y):
            jitted = compile_step(step2, [x, y], [])
            secure_pending_snapshots([x, y])
            out, aux = jitted([x, y], [])
            return out
        """,
    "test_double_donate_guard_clean_twin": """
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def _donation_guard(buffers):
            return buffers

        def step2(states):
            return [states[0] + states[1], states[1]]

        def launch(x):
            jitted = compile_step(step2, [x, x], [])
            secure_pending_snapshots([x])
            _donation_guard([x, x])
            out, aux = jitted([x, x], [])
            return out
        """,
    "test_snapshot_gap_bad": """
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def step(state):
            return state + 1

        def launch(n):
            state = torch.zeros(n)
            jitted = compile_step(step, state, [])
            out = jitted(state, [])
            return out
        """,
    "test_snapshot_gap_shield_clean_twin": """
        import torch
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        def step(state):
            return state + 1

        def launch(n):
            state = torch.zeros(n)
            jitted = compile_step(step, state, [])
            secure_pending_snapshots([state])
            out = jitted(state, [])
            return out
        """,
    "test_snapshot_gap_fleet_shield_assignment_with_starred_args": """
        from metrics_tpu_torch.core.fused import compile_step

        def _shield_donation(metric, state):
            return state

        def step(state, *extras):
            return state

        def launch(metric, state, extras, donate):
            jitted = compile_step(step, state, extras)
            if donate:
                state = _shield_donation(metric, state)
            out = jitted(state, *extras)
            return out
        """,
    "test_key_gap_bad": """
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        class Engine:
            def __init__(self):
                self._cache = {}

            def launch(self, tag, state, dyn, scale):
                def step(s, d):
                    return s * scale + d

                key = (tag, state.shape)
                compiled = self._cache.get(key)
                if compiled is None:
                    compiled = compile_step(step, state, [dyn])
                    self._cache[key] = compiled
                secure_pending_snapshots([state])
                out = compiled(state, [dyn])
                return out
        """,
    "test_key_gap_clean_twin": """
        from metrics_tpu_torch.core.fused import compile_step

        def secure_pending_snapshots(buffers):
            return buffers

        class Engine:
            def __init__(self):
                self._cache = {}

            def launch(self, tag, state, dyn, scale):
                def step(s, d):
                    return s * scale + d

                key = (tag, state.shape, dyn.shape, scale)
                compiled = self._cache.get(key)
                if compiled is None:
                    compiled = compile_step(step, state, [dyn])
                    self._cache[key] = compiled
                secure_pending_snapshots([state])
                out = compiled(state, [dyn])
                return out
        """,
}

TORCH_ENGINES = {
    "_FULL_ENGINE": """
        from metrics_tpu_torch.core.fused import compile_step

        _CACHE = {}

        def secure_pending_snapshots(buffers):
            return buffers

        def step(s):
            return s + 1

        def launch(tag, state):
            key = (tag, state.shape)
            compiled = _CACHE.get(key)
            if compiled is None:
                compiled = compile_step(step, state, [])
                _CACHE[key] = compiled
            secure_pending_snapshots([state])
            return compiled(state, [])
        """,
    "_NO_SNAPSHOT_ENGINE": """
        from metrics_tpu_torch.core.fused import compile_step

        _CACHE = {}

        def step(s):
            return s + 1

        def launch(tag, state):
            key = (tag, state.shape)
            compiled = _CACHE.get(key)
            if compiled is None:
                compiled = compile_step(step, state, [])
                _CACHE[key] = compiled
            return compiled(state, [])
        """,
}


def _own(run, directory: pathlib.Path, source: str):
    directory.mkdir()
    path = directory / "mod.py"
    path.write_text(textwrap.dedent(source))
    report = run(str(path), repo_root=str(directory))
    assert report.parse_errors == {} and report.contract == {}
    return report.new_findings


@pytest.mark.parametrize("name", sorted(TORCH_SNIPPETS))
def test_rule_fixtures_match_the_jax_package(tmp_path, name):
    jax_source = _jax_fixtures()[name]
    port_source = TORCH_SNIPPETS[name]
    assert len(textwrap.dedent(port_source).splitlines()) == len(textwrap.dedent(jax_source).splitlines())
    want = _own(jax_run_own, tmp_path / "jax", jax_source)
    got = _own(run_own, tmp_path / "port", port_source)
    assert {(f.rule, f.line, f.symbol) for f in got} == {(f.rule, f.line, f.symbol) for f in want}
    assert bool(want) == ("bad" in name)  # the bad fixtures fire, the clean ones stay silent


def test_fixture_messages_name_the_hazard(tmp_path):
    (alias,) = _own(run_own, tmp_path / "a", TORCH_SNIPPETS["test_donate_alias_bad_pr16_twin"])
    assert "aliases host memory" in alias.message and alias.symbol == "restore"
    (host,) = _own(run_own, tmp_path / "b", TORCH_SNIPPETS["test_donate_alias_host_numpy_bad"])
    assert "host-allocated numpy memory" in host.message
    (uad,) = _own(run_own, tmp_path / "c", TORCH_SNIPPETS["test_use_after_donate_bad"])
    assert "`state` was donated" in uad.message
    (double,) = _own(run_own, tmp_path / "d", TORCH_SNIPPETS["test_double_donate_bad"])
    assert "positions 0 and 1" in double.message
    (gap,) = _own(run_own, tmp_path / "e", TORCH_SNIPPETS["test_snapshot_gap_bad"])
    assert "secure_pending_snapshots" in gap.message
    keys = {f.symbol: f.message for f in _own(run_own, tmp_path / "f", TORCH_SNIPPETS["test_key_gap_bad"])}
    assert "runtime argument of the captured step" in keys["Engine.launch.dyn"]
    assert "closed over by the traced step" in keys["Engine.launch.scale"]


def test_an_in_place_write_through_a_payload_view_is_an_alias(tmp_path):
    """The in-place half of the rule: an accumulation into a tensor over host memory, and
    its clean twin through the restore's owning copy."""
    bad = """
        import numpy as np
        import torch

        def restore(blob, batch):
            state = torch.from_numpy(np.frombuffer(blob, dtype="float32"))
            state.add_(batch)
            return state
        """
    (f,) = _own(run_own, tmp_path / "bad", bad)
    assert (f.rule, f.line, f.symbol) == ("TMO-DONATE-ALIAS", 7, "restore")
    clean = bad.replace("state.add_(batch)", "state = state.clone()\n            state.add_(batch)")
    assert _own(run_own, tmp_path / "clean", clean) == []


def _mini_fleet(build, sources, third):
    model = build({"eng_a.py": ("eng_a", textwrap.dedent(sources["_FULL_ENGINE"])),
                   "eng_b.py": ("eng_b", textwrap.dedent(sources["_FULL_ENGINE"])),
                   "eng_c.py": ("eng_c", textwrap.dedent(sources[third]))})
    return model


@pytest.mark.parametrize("third", ["_NO_SNAPSHOT_ENGINE", "_FULL_ENGINE"])
def test_engine_drift_matches_the_jax_package(third):
    engines = {"a": ("eng_a.py", "launch"), "b": ("eng_b.py", "launch"), "c": ("eng_c.py", "launch")}
    jax_matrix = jax_contract.extract_contract(_mini_fleet(jax_build_model, _jax_fixtures(), third), engines=engines)
    matrix = engine_contract.extract_contract(_mini_fleet(build_model, TORCH_ENGINES, third), engines=engines)
    want, got = jax_contract.drift_findings(jax_matrix), engine_contract.drift_findings(matrix)
    assert [(f.rule, f.path, f.line, f.symbol) for f in got] == [(f.rule, f.path, f.line, f.symbol) for f in want]
    assert bool(got) == (third == "_NO_SNAPSHOT_ENGINE")
    sheet, jax_sheet = engine_contract.worksheet(matrix, got), jax_contract.worksheet(jax_matrix, want)
    assert [d["symbol"] for d in sheet["divergences"]] == [d["symbol"] for d in jax_sheet["divergences"]]
    for engine in engines:
        assert sheet["engines"][engine]["components"] == jax_sheet["engines"][engine]["components"]
        assert sheet["engines"][engine]["key_fields"] == jax_sheet["engines"][engine]["key_fields"] == [
            "tag", "state.shape"]


def test_fixture_sources_are_the_jax_tests_own():
    fixtures = _jax_fixtures()
    assert set(TORCH_SNIPPETS) | set(TORCH_ENGINES) == set(fixtures)
    for name, source in TORCH_ENGINES.items():
        assert len(textwrap.dedent(source).splitlines()) == len(textwrap.dedent(fixtures[name]).splitlines())


# ----------------------------------------------------------------- the port itself


@pytest.fixture(scope="module")
def port_report():
    return run_own(str(REPO / "metrics_tpu_torch"), baseline_path=str(PORT_BASELINE))


def test_the_port_is_clean_against_its_baseline(port_report):
    assert port_report.parse_errors == {}
    assert port_report.new_findings == [], "\n".join(f.format() for f in port_report.new_findings)
    assert port_report.unused_waivers == []
    assert all(f.waive_reason for f in port_report.waived)
    assert all(f.rule.startswith("TMO-") for f in port_report.waived)
    assert port_report.stats["seconds"] < 60


def test_the_port_engines_and_their_contract(port_report):
    contract = port_report.contract
    assert set(contract) == {"fused", "fleet", "ingest", "rank"}
    for engine in ("fused", "fleet", "ingest"):
        have = {c for c, ev in contract[engine]["components"].items() if ev}
        assert {"donation", "executable_cache", "demote_on_failure", "warm_manifest_record"} <= have, engine
        assert contract[engine]["key_fields"], engine
    # the shields the port has no counterpart of stay in the contract, absent everywhere
    for component in ("donation_guard", "snapshot_before_donate"):
        assert not any(contract[e]["components"][component] for e in contract)
    assert not any(contract["rank"]["components"].values())  # the rank tiers cache no step
    assert any("dyn_key" in field for field in contract["fused"]["key_fields"])


def test_the_drift_worksheet_is_in_sync(port_report):
    path = REPO / "metrics_tpu_torch" / "analysis" / engine_contract.DRIFT_FILENAME
    checked_in = engine_contract.load_worksheet(str(path))
    assert checked_in == json.loads(json.dumps(port_report.drift_worksheet()))
    recorded = {d["symbol"] for d in checked_in["divergences"]}
    assert recorded == {f.symbol for f in port_report.waived if f.rule == "TMO-ENGINE-DRIFT"}


def test_the_restore_clone_is_the_owning_copy_of_a_payload_view(port_report):
    """``ckpt/serializer.py:_decode`` returns a view of the read blob (the PR 16 shape);
    ``ckpt/restore.py:_owned`` clones where ``.to()`` did not copy: the owning copy."""
    modules = port_report.model.modules
    decode = modules["metrics_tpu_torch/ckpt/serializer.py"].functions["_decode"]
    owned = modules["metrics_tpu_torch/ckpt/restore.py"].functions["_owned"]
    assert decode.returns_alias and not decode.returns_owned
    assert owned.returns_owned and not owned.returns_alias


def test_own_obs_counters(tmp_path):
    from metrics_tpu_torch import obs

    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(TORCH_SNIPPETS["test_donate_alias_host_numpy_bad"]))
    with obs.observe() as reg:
        before = reg.get("own", "donate_alias")
        report = run_own(str(path), repo_root=str(tmp_path))
        assert [f.rule for f in report.new_findings] == ["TMO-DONATE-ALIAS"]
        assert reg.get("own", "donate_alias") == before + 1


# ----------------------------------------------------------------------- CLI


def _cli(*args, cwd=None):
    """``python -m metrics_tpu_torch.analysis`` in a subprocess: its exit code, output, and
    which of ``jax``/``metrics_tpu`` it loaded."""
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


def test_cli_own_on_the_port_exits_0_and_loads_no_jax():
    rc, out, err, loaded = _cli("--own")
    assert rc == 0 and loaded == [], out + err
    assert "4 engines" in out and "0 new" in out


@pytest.mark.parametrize("name,rule", [("test_use_after_donate_bad", "TMO-USE-AFTER-DONATE"),
                                       ("test_donate_alias_bad_pr16_twin", "TMO-DONATE-ALIAS")])
def test_cli_own_exits_1_with_the_rule_on_a_seeded_package(tmp_path, name, rule):
    pkg = tmp_path / "seeded"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent(TORCH_SNIPPETS[name]))
    rc, out, err, loaded = _cli(str(pkg), "--own", cwd=str(tmp_path))
    assert rc == 1 and rule in out and loaded == [], out + err
    clean = name.replace("_bad", "_repoint_clean_twin") if "use_after" in name else \
        "test_donate_alias_clean_twin_owned_copy"
    (pkg / "mod.py").write_text(textwrap.dedent(TORCH_SNIPPETS[clean]))
    assert _cli(str(pkg), "--own", cwd=str(tmp_path))[0] == 0


def test_cli_usage_errors_exit_2():
    assert _cli("--own", "--san")[0] == 2
    assert _cli("--write-drift")[0] == 2
    assert _cli("--own", "--select", "TMO-NOPE")[0] == 2
    rc, out, _, _ = _cli("--explain", "TMO-USE-AFTER-DONATE")
    assert rc == 0 and "replay" in out
