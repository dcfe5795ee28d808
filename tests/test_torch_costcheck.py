"""The cost cross-check of metrics_tpu_torch (``obs/costcheck.py``) against the JAX
package's ``obs.costcheck``, on the CPU.

- One synthetic registry snapshot with budgeted, drifting, amortized and unbudgeted
  classes and infrastructure scopes: the port's report rows (scopes, counts, ratios,
  variants, wall times) and its warning equal the JAX ``crosscheck`` on the same
  counts. The JAX side reads a temporary costs file stamped with the running jax
  version and backend; the port side reads a budget stamped with the running torch,
  CUDA and device, whose entries read 1.0 (the JAX rule of one dispatch an update),
  with the JAX ``dispatches`` given as ``kernel_launches``. The port's names for the
  JAX ``static_*`` keys and words are mapped before the comparison (a deliberate
  deviation: the budget is measured on the card, not a static model).
- A stamp skew turns the warning into a note; a missing budget file gives the JAX
  note; the gate off gives an empty report.
- ``write_budget(path, device="cpu")`` writes the JAX key set (the ``.update[canon]``
  entries of ``tmsan_costs.json``) and the fused entry, with every other root export
  named among the skips with its reason.
- The credit of kernel launches: the innermost scope, nothing with the gate off, and no
  launch from an update on the CPU.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import metrics_tpu.obs as jobs
from metrics_tpu.analysis.registry import NOT_INTROSPECTED
from metrics_tpu.obs import costcheck as jcostcheck
from metrics_tpu_torch import _build, obs
from metrics_tpu_torch.classification import MulticlassAccuracy
from metrics_tpu_torch.obs import costcheck, registry
from tests.torch_deadline import deadline  # noqa: F401
from tests.torch_globals import restores_globals  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: scope -> (updates, launches, wall seconds or None); budgeted: the first five
SNAPSHOT = {
    "MulticlassAccuracy": (10, 10, 0.25),   # 1.0: checked
    "BinaryAUROC": (10, 11, None),          # 1.1: checked (inside +15%)
    "MeanSquaredError": (8, 13, None),      # 1.625: drift
    "BinaryStatScores": (20, 4, None),      # 0.2: amortized
    "SumMetric": (5, 6, 0.5),               # 1.2: drift
    "CatMetric": (0, 3, None),              # no updates: not a row
    "NotInBudget": (4, 4, None),            # unbudgeted
    "fused": (10, 30, None),                # infrastructure
}
BUDGETED = ("MulticlassAccuracy", "BinaryAUROC", "MeanSquaredError", "BinaryStatScores", "SumMetric", "CatMetric")

#: the port's words for the JAX static model's
PORT_WORDS = (("static budget", "launch budget"), ("vs static", "vs budget"),
              ("executables per update than tmsan certified", "kernels per update than the budget stamped on the card"),
              ("dispatch regression", "launch regression"))


@pytest.fixture(autouse=True)
def _leaves_nothing_behind(restores_globals):
    registry.REGISTRY.clear()
    jobs.REGISTRY.clear()
    yield
    obs.disable()
    jobs.disable()
    registry.REGISTRY.clear()
    jobs.REGISTRY.clear()
    assert not registry._ENABLED


def _snapshots():
    jsnap, tsnap = {}, {}
    for scope, (updates, launches, wall) in SNAPSHOT.items():
        timer = {} if wall is None else {"update_time": {"count": updates, "total_s": wall}}
        jsnap[scope] = {"updates": updates, "dispatches": launches, **timer}
        tsnap[scope] = {"updates": updates, "kernel_launches": launches, **timer}
    return jsnap, tsnap


def _write(path, payload):
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return str(path)


def _jax_costs(tmp_path, jax_version=None):
    entries = {f"{c}.update[canon]": {"flops": 1.0, "bytes_accessed": 1.0, "peak_bytes": 1.0} for c in BUDGETED}
    entries["ops.confusion_counts[canon:num_classes=5]"] = {"flops": 1.0}
    (tmp_path / "jax").mkdir(exist_ok=True)
    return _write(tmp_path / "jax" / costcheck.BUDGET_FILENAME, {
        "version": 1, "jax": jax_version or jax.__version__, "backend": jax.default_backend(), "entries": entries})


def _port_budget(tmp_path, stamp=None, figures=None):
    entries = {f"{c}.update[canon]": {"launches_per_update": {}, "kernel_launches_per_update": (figures or {}).get(c, 1.0),
                                      "cuda_kernels_per_update": None, "cuda_copies_per_update": None}
               for c in BUDGETED}
    entries[costcheck.FUSED_KEY] = {"replays_per_step": 1, "launches_per_replay": {}}
    (tmp_path / "port").mkdir(exist_ok=True)
    return _write(tmp_path / "port" / costcheck.BUDGET_FILENAME,
                  {"version": 1, "stamp": stamp or costcheck.running_stamp(), "entries": entries, "skipped": {}})


def _port_rows(rows):
    return [{("dispatches" if k == "kernel_launches" else "static_launches_per_update"
              if k == "budget_launches_per_update" else k): v for k, v in r.items()} for r in rows]


def _as_port_text(text):
    for jax_words, port_words in PORT_WORDS:
        text = text.replace(jax_words, port_words)
    return "metrics_tpu_torch.obs: " + text


def _run_both(tmp_path, **port_budget):
    jsnap, tsnap = _snapshots()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jrep = jcostcheck.crosscheck(_jax_costs(tmp_path), snapshot=jsnap)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        trep = costcheck.crosscheck(_port_budget(tmp_path, **port_budget), snapshot=tsnap)
    return jrep, trep, [w for w in jw if issubclass(w.category, jcostcheck.CostDriftWarning)], \
        [w for w in tw if issubclass(w.category, costcheck.CostDriftWarning)]


def test_report_rows_and_warning_equal_the_jax_crosscheck(tmp_path):
    jrep, trep, jwarn, twarn = _run_both(tmp_path)
    assert jrep["version_ok"] is True and trep["version_ok"] is True
    for key in ("checked", "drifts", "amortized"):
        assert _port_rows(trep[key]) == jrep[key], key
    assert [r["scope"] for r in trep["drifts"]] == ["MeanSquaredError", "SumMetric"]
    assert [r["scope"] for r in trep["amortized"]] == ["BinaryStatScores"]
    assert trep["unbudgeted"] == jrep["unbudgeted"] == ["NotInBudget"]
    assert trep["notes"] == jrep["notes"] == [] and trep["tolerance"] == jrep["tolerance"]
    assert len(jwarn) == len(twarn) == 1
    assert str(twarn[0].message) == _as_port_text(str(jwarn[0].message))
    assert set(trep) == set(jrep) - {"static_jax"} | {"budget_stamp"}
    assert trep["budget_stamp"] == "torch={torch}/cuda={cuda}/{device}".format(**costcheck.running_stamp())


def test_warn_false_gives_the_warning_as_a_note(tmp_path):
    jsnap, tsnap = _snapshots()
    jrep = jcostcheck.crosscheck(_jax_costs(tmp_path), snapshot=jsnap, warn=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", costcheck.CostDriftWarning)
        trep = costcheck.crosscheck(_port_budget(tmp_path), snapshot=tsnap, warn=False)
    assert [_as_port_text(n) for n in jrep["notes"]] == trep["notes"] and len(trep["notes"]) == 1


def test_a_stamp_skew_turns_the_warning_into_a_note(tmp_path):
    jsnap, tsnap = _snapshots()
    skew = {"torch": "2.11.0+cu128", "cuda": "12.8", "device": "NVIDIA H100 80GB HBM3"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jrep = jcostcheck.crosscheck(_jax_costs(tmp_path, jax_version="0.0.0"), snapshot=jsnap)
        trep = costcheck.crosscheck(_port_budget(tmp_path, stamp=skew), snapshot=tsnap)
    assert jrep["version_ok"] is False and trep["version_ok"] is False
    assert len(trep["notes"]) == len(jrep["notes"]) == 2
    assert trep["notes"][0] == (f"budget recorded on torch=2.11.0+cu128/cuda=12.8/NVIDIA H100 80GB HBM3 but running"
                                f" {costcheck._stamp_text(costcheck.running_stamp())}:"
                                " drift reported as notes, not warnings")
    assert jrep["notes"][0].endswith(": drift reported as notes, not warnings")
    assert trep["notes"][1] == _as_port_text(jrep["notes"][1])
    for key in ("checked", "drifts", "amortized"):
        assert _port_rows(trep[key]) == jrep[key]


def test_a_missing_budget_gives_the_jax_note(tmp_path):
    jrep = jcostcheck.crosscheck(str(tmp_path / "absent.json"), snapshot={})
    trep = costcheck.crosscheck(str(tmp_path / "absent.json"), snapshot={})
    assert {k: v for k, v in trep.items() if k not in ("notes", "budget_stamp")} == \
        {k: v for k, v in jrep.items() if k not in ("notes", "static_jax")}
    assert len(trep["notes"]) == len(jrep["notes"]) == 1
    assert jrep["notes"][0].startswith("tmsan_costs.json not found: run `python -m metrics_tpu.analysis")
    assert trep["notes"][0] == ("launch_budget.json not found: run `python -m metrics_tpu_torch.obs.costcheck"
                                " --write-budget` on the card to record the launch budget")
    broken = tmp_path / "broken.json"
    broken.write_text("{")
    assert costcheck.crosscheck(str(broken), snapshot={})["notes"][0].startswith(f"failed to load {broken}")


def test_the_gate_off_gives_an_empty_report(tmp_path):
    rng = np.random.default_rng(0)
    preds, target = rng.random((64, 5), dtype=np.float32), rng.integers(0, 5, 64).astype(np.int32)
    MulticlassAccuracy(5, device="cpu").update(torch.from_numpy(preds), torch.from_numpy(target))
    trep = costcheck.crosscheck(_port_budget(tmp_path))
    jrep = jcostcheck.crosscheck(_jax_costs(tmp_path))
    for key in ("checked", "drifts", "amortized", "unbudgeted", "notes"):
        assert trep[key] == jrep[key] == []


def test_a_zero_budget_takes_any_launch_as_a_drift_and_private_classes_are_budgeted(tmp_path):
    budget = _port_budget(tmp_path, figures={"MulticlassAccuracy": 0.0})
    snap = {"MulticlassAccuracy": {"updates": 3, "kernel_launches": 1}, "BinaryAUROC": {"updates": 3}}
    with pytest.warns(costcheck.CostDriftWarning, match=r"MulticlassAccuracy: 0.33 launches/update vs budget 0.00"
                                                        r" \(none budgeted\)"):
        rep = costcheck.crosscheck(budget, snapshot=snap)
    assert [r["scope"] for r in rep["drifts"]] == ["MulticlassAccuracy"]
    assert [r["scope"] for r in rep["amortized"]] == ["BinaryAUROC"]  # 0 launches against 1.0
    # the root exports' private shims (``_PeakSignalNoiseRatio``) are budgeted classes;
    # the JAX ``budgeted_classes`` drops them (a fault of the reference, not copied)
    payload = {"entries": {"_PeakSignalNoiseRatio.update[canon]": {}, "fused.collection_update[canon]": {},
                           "HistogramDrift.update[canon:reference=True]": {},
                           "HistogramDrift.update[canon:reference=False]": {}}}
    assert costcheck.budgeted_classes(payload) == {"_PeakSignalNoiseRatio": 1, "HistogramDrift": 2}
    assert jcostcheck.budgeted_classes(payload) == {"HistogramDrift": 2}


def test_write_budget_on_the_cpu_writes_the_jax_key_set(tmp_path):
    payload = costcheck.write_budget(str(tmp_path / "budget.json"), device="cpu")
    assert json.loads((tmp_path / "budget.json").read_text()) == payload
    with open(os.path.join(REPO, "tmsan_costs.json")) as fh:
        jax_keys = {k for k in json.load(fh)["entries"] if ".update[canon" in k and k[0] != "f"}
    assert len(jax_keys) == 107
    assert set(payload["entries"]) == jax_keys | {costcheck.FUSED_KEY}
    assert payload["stamp"] == costcheck.running_stamp() and payload["batch"] == 64
    for key, entry in payload["entries"].items():
        if key == costcheck.FUSED_KEY:
            assert entry == {"replays_per_step": 1.0, "launches_per_replay": {}}
        else:  # no kernel runs on the CPU, and no CUDA trace is taken
            assert entry == {"launches_per_update": {}, "kernel_launches_per_update": 0,
                             "cuda_kernels_per_update": None, "cuda_copies_per_update": None}, key
    skipped = payload["skipped"]
    assert set(NOT_INTROSPECTED) <= set(skipped)
    assert all(skipped[name] == reason for name, reason in NOT_INTROSPECTED.items())
    assert skipped["BLEUScore"] == "declared _host_side_update (host code by contract)"
    assert skipped["MeanAveragePrecision"] == "no canonical input spec"


def test_launches_credit_the_innermost_scope_only_with_the_gate_on():
    class Stand:
        launches = 0

    kernel = Stand()
    _build.note_launch(kernel)  # the gate off: counted, credited nowhere
    obs.enable()
    with _build.crediting("Outer"):
        _build.note_launch(kernel, 2)
        with _build.crediting("Inner"):
            _build.note_launch(kernel)
        _build.note_launch(kernel)
    _build.note_launch(kernel)  # outside any scope
    with _build.capture_tally() as tally, _build.crediting("Outer"):
        _build.note_launch(kernel)  # a captured launch has not run
    assert kernel.launches == 6 and tally == {kernel: 1}
    snap = obs.snapshot()
    assert snap["Outer"]["kernel_launches"] == 3 and snap["Inner"]["kernel_launches"] == 1
    obs.disable()
    with _build.crediting("Outer"):
        _build.note_launch(kernel)
    assert registry.REGISTRY.get("Outer", "kernel_launches") == 3


def test_a_cpu_update_with_the_gate_on_credits_no_launch():
    obs.enable()
    rng = np.random.default_rng(1)
    metric = MulticlassAccuracy(5, average=None, device="cpu")
    for _ in range(3):
        metric.update(torch.from_numpy(rng.random((64, 5), dtype=np.float32)),
                      torch.from_numpy(rng.integers(0, 5, 64).astype(np.int32)))
    counters = obs.snapshot()["MulticlassAccuracy"]
    assert counters["updates"] == 3 and counters.get("kernel_launches", 0) == 0


def test_obs_exports_equal_the_jax_package():
    assert sorted(obs.__all__) == sorted(jobs.__all__)
    assert obs.crosscheck is costcheck.crosscheck and obs.CostDriftWarning is costcheck.CostDriftWarning
    assert issubclass(obs.CostDriftWarning, RuntimeWarning) and costcheck.DRIFT_TOLERANCE == jcostcheck.DRIFT_TOLERANCE
