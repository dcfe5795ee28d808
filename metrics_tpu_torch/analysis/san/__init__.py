"""metrics_tpu_torch.analysis.san — the card tier: host syncs caught on the card.

Counterpart of ``metrics_tpu/analysis/san/``'s crosscheck. The JAX package reads
its ground truth from jaxprs; the port reads it from the card: every budgeted
class's update runs once inside a traced step under
``torch.cuda.set_sync_debug_mode("warn")``, and the lines that synchronised and
the lines that ran are held against tmlint's TM-HOSTSYNC findings and waivers.

==================  =========================================================
rule                what it catches
==================  =========================================================
TMS-LINTGAP         a line that synced on the card in a tmlint-clean function
TMS-STALE-WAIVER    a TM-HOSTSYNC waiver whose line ran traced without a sync
==================  =========================================================

CLI::

    python -m metrics_tpu_torch.analysis --card        # lint + the card's evidence

It needs a card, and raises without one.
"""
from metrics_tpu_torch.analysis.san.crosscheck import corroborate_waivers, lintgap_findings
from metrics_tpu_torch.analysis.san.runner import CardEvidence, CardReport, collect_card_evidence, run_card

__all__ = [
    "CardEvidence",
    "CardReport",
    "collect_card_evidence",
    "corroborate_waivers",
    "lintgap_findings",
    "run_card",
]
