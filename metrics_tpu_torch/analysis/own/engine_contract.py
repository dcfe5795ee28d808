"""TMO-ENGINE-DRIFT: machine-checked inventory of the port's launch engines.

Counterpart of ``metrics_tpu/analysis/own/engine_contract.py``. fused, fleet, ingest,
and the rank tiers each implement the same launch contract — static-buffer
accumulation through a captured step, the shields around it, a keyed step cache,
demote-on-failure, and the warm-manifest record. This module extracts each engine's
implementation of every contract component from the ownership model and flags
divergence; its full per-engine matrix is the checked-in worksheet
(``metrics_tpu_torch/analysis/tmown_engine_drift.json``).

A component is *drifted* when an engine lacks it while at least two other
engines implement it — "everyone but you" is the signal that one copy of the
contract went its own way (a component nobody has is just not part of the
contract yet). Where the port has no counterpart of a JAX shield (the
duplicate-buffer dedup, the snapshot guard: the port's async snapshot is a copy
taken at the save call), the component stays in the contract and shows as absent.
"""
import json
from typing import Dict, List, Optional, Tuple

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.own.buffer_model import OwnFunc, OwnModel, OwnModuleModel

DRIFT_FILENAME = "tmown_engine_drift.json"

#: engine -> (repo-relative path, anchor qualname or None for whole-module).
#: The anchor is the replaying launch path; component evidence is gathered over
#: the anchor plus its transitively-called package functions.
ENGINES: Dict[str, Tuple[str, Optional[str]]] = {
    "fused": ("metrics_tpu_torch/core/fused.py", "FusedCollectionUpdate._launch"),
    "fleet": ("metrics_tpu_torch/core/fleet.py", "run_step"),
    "ingest": ("metrics_tpu_torch/serve/ingest.py", "IngestQueue._launch_chain"),
    "rank": ("metrics_tpu_torch/ops/clf_curve.py", None),  # module-level rank tiers: no step cached
}

#: the shared contract: component -> human description (worksheet rows)
COMPONENTS: Dict[str, str] = {
    "donation": "static-buffer accumulation: a captured step's replay writes the states in place (StepCache.call)",
    "donation_guard": "duplicate-state dedup before a replay (_donation_guard)",
    "snapshot_before_donate": "pending async-ckpt snapshots secured before a replay (secure_pending_snapshots)",
    "default_shield": "the registered defaults cloned, never captured as static buffers (init_state / _protected_ids)",
    "executable_cache": "the keyed StepCache of captured steps",
    "demote_on_failure": "StepCache.broken: a key whose capture or replay failed runs eagerly, never retries",
    "warm_manifest_record": "the excache record of a capture for prewarm replay (record_*_compile)",
}


def _reachable(
    model: OwnModel, module: OwnModuleModel, func: OwnFunc, _seen=None
) -> List[OwnFunc]:
    """The anchor plus every package function it transitively calls — walked
    over the raw AST call symbols so helper evidence (``_gather_states`` ->
    ``_protected_ids``) counts toward its engine."""
    import ast

    from metrics_tpu_torch.analysis.jitmap import dotted_name

    if _seen is None:
        _seen = set()
    key = (module.path, func.qualname)
    if key in _seen:
        return []
    _seen.add(key)
    out = [func]
    node = module.find_def(func.qualname)
    if node is None:
        return out
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if not name:
                continue
            hit = model.resolve_call(module, name, func)
            if hit:
                out.extend(_reachable(model, hit[0], hit[1], _seen))
    return out


def _engine_facts(
    model: OwnModel, path: str, anchor: Optional[str]
) -> Optional[Dict]:
    module = model.modules.get(path)
    if module is None:
        return None
    if anchor is not None:
        root = module.functions.get(anchor)
        if root is None:
            return None
        funcs = _reachable(model, module, root)
        anchor_line = root.line
    else:
        funcs = list(module.functions.values())
        anchor_line = 1

    def evidence(pred) -> Optional[str]:
        for f in funcs:
            if pred(f):
                return f.qualname
        return None

    present: Dict[str, Optional[str]] = {
        "donation": evidence(lambda f: f.exec_sites > 0 or f.builds_donating),
        "donation_guard": evidence(lambda f: "dedup" in f.shield_calls or f.dedup_shield),
        "snapshot_before_donate": evidence(
            lambda f: "snapshot" in f.shield_calls or f.snapshot_shield
        ),
        "default_shield": evidence(
            lambda f: "_protected_ids" in f.qualname
            or any(e.split(".")[-1] in ("_protected_ids", "init_state") for e in _called_names(model, module, f))
        ),
        "executable_cache": evidence(lambda f: f.cache_get or f.cache_store),
        "demote_on_failure": evidence(lambda f: f.demote_sentinel),
        "warm_manifest_record": evidence(lambda f: bool(f.warm_records)),
    }
    key_fields: List[str] = []
    for f in funcs:
        if f.key_fields:
            key_fields = f.key_fields
            break
    return {
        "path": path,
        "anchor": anchor or "<module>",
        "anchor_line": anchor_line,
        "components": present,
        "key_fields": key_fields,
    }


def _called_names(model: OwnModel, module: OwnModuleModel, func: OwnFunc) -> List[str]:
    import ast

    from metrics_tpu_torch.analysis.jitmap import dotted_name

    node = module.find_def(func.qualname)
    if node is None:
        return []
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            if name:
                out.append(name)
    return out


def extract_contract(
    model: OwnModel, engines: Optional[Dict[str, Tuple[str, Optional[str]]]] = None
) -> Dict[str, Dict]:
    """Per-engine component matrix; engines whose anchor file is absent from
    the analyzed tree are skipped (fixture runs never see the repo anchors)."""
    engines = ENGINES if engines is None else engines
    out: Dict[str, Dict] = {}
    for name, (path, anchor) in engines.items():
        facts = _engine_facts(model, path, anchor)
        if facts is not None:
            out[name] = facts
    return out


def drift_findings(matrix: Dict[str, Dict]) -> List[Finding]:
    """One finding per (engine, component absent while >= 2 peers have it)."""
    out: List[Finding] = []
    for component, description in COMPONENTS.items():
        holders = [e for e, facts in matrix.items() if facts["components"].get(component)]
        if len(holders) < 2:
            continue
        for engine, facts in sorted(matrix.items()):
            if facts["components"].get(component):
                continue
            out.append(
                Finding(
                    rule="TMO-ENGINE-DRIFT",
                    path=facts["path"],
                    line=facts["anchor_line"],
                    col=0,
                    symbol=f"{engine}.{component}",
                    message=(
                        f"engine contract drift: {engine} lacks "
                        f"'{component}' ({description}) implemented by "
                        f"{', '.join(sorted(holders))} — see {DRIFT_FILENAME}"
                    ),
                )
            )
    out.sort(key=lambda f: (f.path, f.symbol))
    return out


def worksheet(matrix: Dict[str, Dict], findings: List[Finding]) -> Dict:
    """The checked-in worksheet payload (deterministic)."""
    return {
        "version": 1,
        "comment": (
            "tmown engine-contract worksheet of metrics_tpu_torch: each launch"
            " engine's implementation of the shared contract. Regenerate with"
            " `python -m metrics_tpu_torch.analysis --own --write-drift` after"
            " engine changes; tests/test_torch_analysis_own.py compares this file"
            " to a fresh run."
        ),
        "contract": COMPONENTS,
        "engines": {
            name: {
                "path": facts["path"],
                "anchor": facts["anchor"],
                "components": {
                    comp: facts["components"].get(comp) for comp in COMPONENTS
                },
                "key_fields": facts["key_fields"],
            }
            for name, facts in sorted(matrix.items())
        },
        "divergences": [
            {"symbol": f.symbol, "message": f.message} for f in findings
        ],
    }


def write_worksheet(path: str, payload: Dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=False)
        fh.write("\n")


def load_worksheet(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)
