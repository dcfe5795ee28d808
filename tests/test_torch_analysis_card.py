"""The card tier of metrics_tpu_torch's static analyzer (``analysis/san/``), on the card.

Every test here needs a CUDA card: each is marked ``cuda`` and skips elsewhere. The file
imports neither JAX nor metrics_tpu, so that it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_analysis_card.py

- Every budgeted class's update, traced (``tracing()``) under the sync debug mode, makes
  no synchronising call, and the crosscheck against tmlint finds no lint gap and no stale
  waiver.
- A traced ``.item()`` the AST tier cannot see is caught as one TMS-LINTGAP at its line.
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


@pytest.mark.cuda
def test_budgeted_updates_sync_nowhere_and_the_crosscheck_is_clean(cuda):
    before = torch.cuda.get_sync_debug_mode()
    report = run_card(str(REPO / "metrics_tpu_torch"), device="cuda")
    assert torch.cuda.get_sync_debug_mode() == before
    assert report.evidence.skipped == {}
    assert len(report.evidence.by_case) >= 100
    assert [s for s in report.evidence.synced if s[1]] == []
    assert report.findings == [] and report.exit_code == 0
    assert report.evidence.footprint  # the traced updates ran the port's lines


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
