"""metrics_tpu_torch.analysis — **tmlint**, the port's static analyzer.

Counterpart of ``metrics_tpu/analysis/``, with its module names, rule IDs,
``Finding`` fields and key, baseline file format, and CLI flags and exit codes.
The ``Metric`` contract has invariants no type checker sees: an update or compute
body that the engines run as a traced step (a CUDA graph capture, a
``torch.func`` transform, ``utils/checks.py:tracing()``) must not read device
values on the host, branch on them or make data-dependent shapes; and state may
only flow through the registry that ``ckpt/`` serializes and ``Metric.sync``
gathers. tmlint checks them statically:

==================  =========================================================
rule                what it catches
==================  =========================================================
TM-HOSTSYNC         ``.item()``/``.cpu()``/``float()``/numpy in traced code
TM-PYBRANCH         ``if``/``while``/``assert`` on tensor values
TM-DYNSHAPE         ``torch.unique``/``nonzero``/bool-mask, dynamic lengths
TM-RETRACE          per-call Python values into a step key (recapture storm)
TM-STATE-UNREG      ``update`` mutates attrs never passed to ``add_state``
TM-REDUCE-MISMATCH  ``dist_reduce_fx`` the sync/re-reduce cannot honor
TM-PERSIST          tensor state the ckpt serializer silently drops
==================  =========================================================

Each rule is cross-linked to what would show at run time (``--explain RULE``):
a capture that fails and demotes its group to eager, or a
``metrics_tpu_torch.obs`` counter. The trace rules know the port's trace
boundary (``jitmap.py``) and its ``_is_concrete`` guard idiom, so host-side code
is not flagged. The introspection tier builds every metric class on a device
given by the caller (the card by default); without a card it raises unless asked
for the CPU.

The other tiers of the port:

- ``san/`` (**tmsan**): the abstract tier (``--san``) traces every budgeted class's update
  and compute on fake tensors (TMS-CALLBACK, TMS-F64, TMS-UPCAST, TMS-BIGCONST,
  TMS-COLLECTIVE, TMS-DYNSHAPE) and holds the traced costs against
  ``analysis/san_costs.json`` (TMS-BUDGET, written on the card); the card tier (``--card``)
  reads the lines that synchronise on the card inside traced updates and computes
  (``torch.cuda.set_sync_debug_mode``); both are held against tmlint's TM-HOSTSYNC findings
  and waivers (TMS-LINTGAP, TMS-STALE-WAIVER);
- ``race/`` (**tmrace**), the JAX package's concurrency tier over the port's
  ``utils/concurrency.py`` vocabulary (``--race``);
- ``own/`` (**tmown**): buffer ownership over the captured steps' static buffers and
  in-place accumulations, and the launch engines' contract drift (``--own``, the worksheet
  ``analysis/tmown_engine_drift.json``).

Not covered yet, each listed in ``ROADMAP.md``: ``shard/`` (tmshard, collectives and
placement), the race stress tier, and ``bench_history.py``.

CLI::

    python -m metrics_tpu_torch.analysis metrics_tpu_torch/ --device cpu
    python -m metrics_tpu_torch.analysis --san --device cpu
    python -m metrics_tpu_torch.analysis --race
    python -m metrics_tpu_torch.analysis --own
    python -m metrics_tpu_torch.analysis --card
    python -m metrics_tpu_torch.analysis --explain TM-HOSTSYNC

CI fails only on findings not waived in
``metrics_tpu_torch/analysis/tmlint_baseline.json``.
"""
from metrics_tpu_torch.analysis.baseline import (
    BASELINE_FILENAME,
    apply_baseline,
    default_baseline_path,
    load_baseline,
    write_baseline,
)
from metrics_tpu_torch.analysis.findings import INTROSPECTION_RULES, RULES, Finding, Rule, explain
from metrics_tpu_torch.analysis.runner import Report, analyze

__all__ = [
    "BASELINE_FILENAME",
    "Finding",
    "INTROSPECTION_RULES",
    "RULES",
    "Report",
    "Rule",
    "analyze",
    "apply_baseline",
    "default_baseline_path",
    "explain",
    "load_baseline",
    "write_baseline",
]
