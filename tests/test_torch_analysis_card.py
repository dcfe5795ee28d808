"""The card tier of metrics_tpu_torch's static analyzer (``analysis/san/``), on the card.

Every test here needs a CUDA card: each is marked ``cuda`` and skips elsewhere. The file
imports neither JAX nor metrics_tpu, so that it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_analysis_card.py

- Every budgeted class's update, and the compute of each class whose compute the engines
  run as a traced step, traced (``tracing()``) under the sync debug mode: the crosscheck
  against tmlint finds no lint gap and no stale waiver (a compute's sync is a waived one).
- The abstract tier on fake ``cuda`` tensors: clean against the baseline, no hand kernel
  launched; its host reads held against the card's syncs, each exception with its reason.
- A traced ``.item()`` the AST tier cannot see is caught as one TMS-LINTGAP at its line; in
  a seeded compute it is a TMS-CALLBACK of the abstract tier and a TMS-LINTGAP of the card.
- The TMO-USE-AFTER-DONATE twin, run through ``compile_step``: tmown flags it, and the
  stale read the rule predicts shows: a step buffer read after the next replay.
- The card tier refuses a CPU device, and leaves the sync debug mode as it found it.
"""
import pathlib
import textwrap

import pytest
import torch

from metrics_tpu_torch.analysis.runner import analyze
from metrics_tpu_torch.analysis.san.runner import collect_card_evidence, run_card
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card tier reads synchronising calls on the device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_report():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card tier reads synchronising calls on the device")
    before = torch.cuda.get_sync_debug_mode()
    report = run_card(str(REPO / "metrics_tpu_torch"), device="cuda")
    assert torch.cuda.get_sync_debug_mode() == before
    return report


@pytest.mark.cuda
def test_budgeted_updates_sync_nowhere_and_the_crosscheck_is_clean(card_report):
    report = card_report
    assert report.evidence.skipped == {}
    assert len(report.evidence.by_case) >= 100 and len(report.evidence.computes) >= 90
    assert [ln for lines in report.evidence.by_case.values() for ln in lines] == []  # the updates sync nowhere
    # a compute's syncs are waived host work (FID's eigh); a compute that raises is recorded with its reason
    assert all(report.evidence.compute_skipped.values())
    assert report.findings == [] and report.exit_code == 0
    assert report.evidence.footprint  # the traced updates ran the port's lines


@pytest.mark.cuda
def test_the_abstract_tier_on_fake_cuda_launches_nothing_and_agrees_with_the_card(card_report):
    from metrics_tpu_torch.analysis.san.runner import crosscheck_tiers, run_san
    from metrics_tpu_torch.ops import greedy_match, histogram, kendall, segment

    wrappers = (histogram.histogram_cuda, histogram.histogram_batched_cuda, segment.segment_scan_cuda,
                greedy_match.greedy_match_cuda, kendall.kendall_pairs_cuda)
    before = [w.launches for w in wrappers]
    report = run_san(str(REPO / "metrics_tpu_torch"), device="cuda", lint=card_report.lint)
    assert [w.launches for w in wrappers] == before
    assert report.new_findings == [], [f.format() for f in report.new_findings]
    assert report.stats["canon_cases"] >= 107 and all(report.skipped.values())
    assert report.kernel_ops
    tiers = crosscheck_tiers(report.host_work(onto_card=True),
                             card_report.evidence.synced, card_report.evidence.footprint)
    assert all(reason for _, _, reason in tiers["exceptions"])


@pytest.mark.cuda
def test_a_hidden_traced_item_is_one_lint_gap(cuda, tmp_path):
    path = tmp_path / "seeded.py"
    path.write_text(textwrap.dedent("""
        from metrics_tpu_torch.classification import BinaryAccuracy


        class Seeded(BinaryAccuracy):
            def update(self, preds, target):
                super().update(preds, target)
                getattr(preds.sum(), "it" + "em")()
        """))
    namespace = {}
    exec(compile(path.read_text(), str(path), "exec"), namespace)
    args = (torch.rand(64, device=cuda), torch.randint(0, 2, (64,), device=cuda))
    case = ("Seeded.update[canon]", lambda: namespace["Seeded"](device="cuda"), args, {})
    lint = analyze(str(path), introspect=False, repo_root=str(tmp_path))
    report = run_card(str(path), repo_root=str(tmp_path), device="cuda", cases=[case], lint=lint,
                      roots=[str(tmp_path)])
    assert lint.findings == []
    assert [(f.rule, f.path, f.line) for f in report.findings] == [("TMS-LINTGAP", "seeded.py", 8)]


@pytest.mark.cuda
def test_the_card_tier_refuses_the_cpu(cuda):
    with pytest.raises(RuntimeError, match="no CPU mode"):
        collect_card_evidence("cpu", cases=[])


SEEDED_COMPUTE = """
from metrics_tpu_torch.classification import BinaryAccuracy


class SeededComputeRead(BinaryAccuracy):
    def compute(self):
        value = super().compute()
        getattr(value.sum(), "it" + "em")()
        return value
"""


@pytest.mark.cuda
def test_a_seeded_compute_read_is_a_callback_and_a_lint_gap(cuda, tmp_path):
    from metrics_tpu_torch.analysis.san.abstract_inputs import TraceCase
    from metrics_tpu_torch.analysis.san.runner import trace_metric

    path = tmp_path / "seeded_compute.py"
    path.write_text(SEEDED_COMPUTE)
    namespace = {}
    exec(compile(path.read_text(), str(path), "exec"), namespace)
    args = (torch.rand(64, device=cuda), torch.randint(0, 2, (64,), device=cuda))
    got = trace_metric(namespace["SeededComputeRead"](device="cuda"), {"canon": [TraceCase("canon", args)]},
                       str(tmp_path), [str(tmp_path)], torch.device("cuda"), with_costs=False)
    assert [(f.rule, f.path, f.line, f.symbol) for f in got["findings"]] == [
        ("TMS-CALLBACK", "seeded_compute.py", 8, "SeededComputeRead.compute")]
    case = ("SeededComputeRead.update[canon]", lambda: namespace["SeededComputeRead"](device="cuda"), args, {})
    lint = analyze(str(path), introspect=False, repo_root=str(tmp_path))
    report = run_card(str(path), repo_root=str(tmp_path), device="cuda", cases=[case], lint=lint,
                      roots=[str(tmp_path)])
    assert [(f.rule, f.path, f.line) for f in report.findings] == [("TMS-LINTGAP", "seeded_compute.py", 8)]


STALE_READ = """
import torch
from metrics_tpu_torch.core.fused import compile_step

def secure_pending_snapshots(buffers):
    return buffers

def step(state, x):
    return {"s": state["s"] + x}, None

def launch(x):
    state = {"s": torch.zeros_like(x)}
    jitted = compile_step(step, state, [x])
    secure_pending_snapshots([state])
    state, _ = jitted(state, [x])
    before = state
    kept = state["s"].clone()
    after, _ = jitted(before, [x])
    stale = before["s"]
    return kept, stale, after["s"]
"""


@pytest.mark.cuda
def test_the_use_after_replay_twin_reads_a_stale_buffer(cuda, tmp_path):
    from metrics_tpu_torch.analysis.own import run_own
    from metrics_tpu_torch.core.fused import is_step_buffer

    path = tmp_path / "stale_read.py"
    path.write_text(STALE_READ)
    report = run_own(str(path), repo_root=str(tmp_path))
    assert [(f.rule, f.line) for f in report.new_findings] == [("TMO-USE-AFTER-DONATE", 19)]
    namespace = {}
    exec(compile(STALE_READ, str(path), "exec"), namespace)
    x = torch.arange(1, 9, dtype=torch.float32, device=cuda)
    kept, stale, after = namespace["launch"](x)
    torch.cuda.synchronize()
    assert is_step_buffer(stale)
    assert torch.equal(kept, x) and torch.equal(after, 2 * x)
    assert not torch.equal(stale, kept) and torch.equal(stale, after)  # the read saw the second replay
