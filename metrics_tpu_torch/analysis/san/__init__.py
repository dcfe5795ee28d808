"""metrics_tpu_torch.analysis.san — **tmsan**: the abstract tier, its cost budget, and the
card tier (counterpart of ``metrics_tpu/analysis/san/``).

The JAX package reads its ground truth from jaxprs. The port reads it twice: from traces
on fake tensors (``FakeTensorMode``: every budgeted class's update and compute, nothing
executes; ``runner.run_san``), and from the card (every budgeted class's update and compute
run once inside a traced step under ``torch.cuda.set_sync_debug_mode("warn")``;
``runner.run_card``). The host reads and the lines that ran are held against tmlint's
TM-HOSTSYNC findings and waivers, and the two tiers against each other
(``runner.crosscheck_tiers``).

==================  =========================================================
rule                what it catches (in the TRACE or on the card, not the source)
==================  =========================================================
TMS-CALLBACK        a host read (``.item()``, a data-dependent output)
TMS-F64             float64 in a trace whose inputs and states hold none
TMS-UPCAST          a bf16/f16 state widened by update
TMS-BIGCONST        a tensor of 64 KiB or more made from host data in a trace
TMS-COLLECTIVE      a collective reached from an update or compute
TMS-DYNSHAPE        a data-dependent output shape (trace failure)
TMS-LINTGAP         a host read in a tmlint-clean function (crosscheck)
TMS-STALE-WAIVER    a TM-HOSTSYNC waiver whose line ran without host work
TMS-BUDGET          traced cost grew >15% over ``analysis/san_costs.json``
==================  =========================================================

CLI::

    python -m metrics_tpu_torch.analysis --san --device cpu    # the abstract tier, fake cpu
    python -m metrics_tpu_torch.analysis --san --write-costs   # on the card: refresh the budget
    python -m metrics_tpu_torch.analysis --card                # the card tier; needs a card

Waivers share ``analysis/tmlint_baseline.json`` (the same (rule, path, symbol) schema);
obs counters live in the ``san.*`` namespace.
"""
from metrics_tpu_torch.analysis.san.costs import COSTS_FILENAME, load_costs, write_costs
from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings
from metrics_tpu_torch.analysis.san.runner import (
    CardEvidence,
    CardReport,
    SanReport,
    collect_card_evidence,
    crosscheck_tiers,
    run_card,
    run_san,
)

__all__ = [
    "COSTS_FILENAME",
    "CardEvidence",
    "CardReport",
    "SanReport",
    "collect_card_evidence",
    "corroborate_waivers",
    "crosscheck_tiers",
    "lintgap_findings",
    "load_costs",
    "run_card",
    "run_san",
    "write_costs",
]
