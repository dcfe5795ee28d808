"""tmrace — the concurrency tier of the port's static analysis (counterpart of
``metrics_tpu/analysis/race/``, the same model and rules).

tmlint reads source text (trace safety), the card tier reads the synchronising
calls of traced updates; tmrace reads the *threading structure*: which thread roles
exist, which locks they take in what order, and which shared attributes they
mutate. Rules: TMR-UNLOCKED, TMR-ORDER, TMR-HOLD-HOST, TMR-HANDLER, TMR-LEAK
(``metrics_tpu_torch/analysis/findings.py``), reported through the shared
``metrics_tpu_torch/analysis/tmlint_baseline.json`` waiver machinery scoped to the ``TMR-*`` namespace.
"""
from metrics_tpu_torch.analysis.race.runner import RaceReport, run_race
from metrics_tpu_torch.analysis.race.thread_model import RaceModel, build_model

__all__ = ["RaceModel", "RaceReport", "build_model", "run_race"]
