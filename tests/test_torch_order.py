"""Port tests that once passed or failed by the order of the files in a worker, each
run here in a pytest subprocess of its own, in the order that broke it, with a deadline:

- a server test's prewarm, then ``test_torch_obs.py``'s state report: the prewarm's
  report stayed in ``serve/excache.py:_LAST_PREWARM`` and was stamped into every later
  state report (``tests/torch_globals.py`` now puts such globals back after each test);
- the render test alone: the JAX compile listener counted the health sketch's first
  compiles unless the file's earlier tests had compiled them (the test compiles them
  itself now, with the gate off);
- a model test, whose module fixture sets torch's thread count and puts it back, then
  the SDR epoch test: after any ``torch.set_num_threads`` with more than one thread,
  MKL's batched LU of the 8 x 512 x 512 float64 Toeplitz systems spun in ``DLASWP``
  for good (``functional/audio/sdr.py:_solve`` now factors one matrix a call on the
  CPU).
"""
import os
import subprocess
import sys

import pytest

from tests.torch_deadline import deadline  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "server_prewarm_then_obs_state_report": [
        "tests/test_torch_server.py::test_drain_commits_and_restart_restores_with_prewarm",
        "tests/test_torch_obs.py::test_state_report_rows_equal_the_jax_package",
    ],
    "obs_render_alone": [
        "tests/test_torch_obs.py::test_render_samples_equal_the_jax_package_for_equal_contents",
    ],
    "thread_count_set_then_sdr_solve": [
        "tests/test_torch_model_text.py::test_state_dict_errors_match_jax",
        "tests/test_torch_audio.py::test_sdr_epoch_with_one_perfect_row_is_finite_and_matches_jax_on_the_noisy_rows",
    ],
}

#: seconds a case may take (each passes in well under a minute; the SDR solve spun for good)
CASE_DEADLINE_S = 150


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_in_the_order_that_broke_them_pass(case):
    # the outer run's pytest-xdist variables would give the inner run its deadline markers
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
           *CASES[case]]
    try:
        result = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=CASE_DEADLINE_S)
    except subprocess.TimeoutExpired as err:
        pytest.fail(f"{case} ran past {CASE_DEADLINE_S} s: {(err.stdout or '')[-2000:]}")
    assert result.returncode == 0, result.stdout[-4000:] + result.stderr[-2000:]
    assert f"{len(CASES[case])} passed" in result.stdout
