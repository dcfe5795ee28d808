"""tmown — the buffer-ownership tier (TMO-* rules), counterpart of
``metrics_tpu/analysis/own/``.

tmlint reasons about traces, tmsan about what a trace dispatches, tmrace about threads;
tmown reasons about *tensor ownership*: which tensors a captured step's replay or an
in-place accumulation writes, and whether the program owns them. The JAX tier was
born from an aliased host buffer donated into a compiled step; the port's
counterpart of donation is the CUDA-graph static buffer (``core/fused.py``:
``CapturedStep`` writes its state buffers in place at every replay, and
``is_step_buffer`` says that a live state is that buffer).

Entry point: ``metrics_tpu_torch.analysis.own.runner.run_own`` /
``python -m metrics_tpu_torch.analysis --own``. Kept import-light like the san and
race tiers — importing ``metrics_tpu_torch.analysis`` does not pull this package.
"""

from metrics_tpu_torch.analysis.own.runner import OwnReport, run_own  # noqa: F401

__all__ = ["OwnReport", "run_own"]
