"""State-contract rules via introspection: TM-STATE-UNREG, TM-REDUCE-MISMATCH,
TM-PERSIST (counterpart of ``metrics_tpu/analysis/contract.py``).

These rules need a *live* instance (the ``add_state`` registry only exists at
run time) plus the AST of the class's ``update``. The instances come from
:mod:`metrics_tpu_torch.analysis.registry`, built on an explicit device. What the
rules hold them to is the port's own: ``Metric.add_state`` registers a tensor
state as a non-persistent buffer, ``Metric.sync`` gathers every registered state
(``utils/distributed.py``) and reduces it with its ``dist_reduce_fx``, and
``ckpt/serializer.py:snapshot_state`` writes exactly the ``_defaults`` registry.

Introspection hooks consumed here (declared on ``core/metric.py``):

- ``_host_side_update`` — class's update/compute are host code by contract
  (text); skips the *trace* rules, not these state rules.
- ``_ckpt_exempt_attrs`` — array attrs intentionally outside the ckpt registry.
- ``_update_signature_attrs`` — constructor knobs; re-derived at construction,
  so the serializer dropping them is correct, not a finding.
"""
import ast
import inspect
import os
import textwrap
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.registry import IntrospectedClass

#: runtime bookkeeping attributes Metric.__init__/_wrap_* own — never state
_RUNTIME_ATTRS = frozenset(
    {
        "_computed", "_forward_cache", "_update_count", "_cache", "_is_synced",
        "_to_sync", "_should_unsync", "_device", "compute_on_cpu", "update",
        "compute", "_defaults", "_persistent", "_reductions", "_cat_meta",
        "_obs_fingerprints", "_obs_retrace_warned", "_fleet_base_defaults",
    }
)
_ARRAY_REDUCTIONS = frozenset({"sum", "mean", "max", "min"})


def _is_array_value(value: Any) -> bool:
    from metrics_tpu_torch.core.state import CatBuffer

    if isinstance(value, CatBuffer):
        return True
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return True
    if isinstance(value, (list, tuple)) and value:
        return all(_is_array_value(v) for v in value)
    return False


def _class_anchor(cls: type, repo_root: str) -> Optional[Tuple[str, int]]:
    try:
        path = inspect.getsourcefile(cls)
        _, line = inspect.getsourcelines(cls)
    except (OSError, TypeError):
        return None
    if path is None:
        return None
    rel = os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
    if rel.startswith(".."):
        return None
    return rel, line


def _method_def(cls: type, name: str):
    """(plain function, defining class) for a method, walking the MRO."""
    for base in cls.__mro__:
        if name in base.__dict__:
            fn = base.__dict__[name]
            if callable(fn):
                return fn, base
    return None, None


def _update_self_assigns(fn) -> Iterable[Tuple[str, int]]:
    """(attr, absolute line) for every ``self.X = ...`` in a method body."""
    try:
        lines, start = inspect.getsourcelines(fn)
    except (OSError, TypeError):
        return []
    try:
        tree = ast.parse(textwrap.dedent("".join(lines)))
    except SyntaxError:
        return []
    out: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Tuple):
                elts = list(t.elts)
            else:
                elts = [t]
            for el in elts:
                if (
                    isinstance(el, ast.Attribute)
                    and isinstance(el.value, ast.Name)
                    and el.value.id == "self"
                ):
                    out.append((el.attr, start + el.lineno - 1))
    return out


def _declared_state_names(cls: type) -> set:
    """Literal first arguments of every ``add_state("...")`` call in the class
    source, walking the MRO down to ``Metric`` — catches conditionally-registered
    states (e.g. the curve metrics register either cat states or a confmat depending
    on the ``thresholds`` ctor arg, so one constructed instance never shows both).
    ``Metric``'s own bases (``nn.Module``) register no state and are not parsed."""
    from metrics_tpu_torch.core.metric import Metric

    names: set = set()
    for base in cls.__mro__:
        if base is Metric:
            break
        names |= _add_state_literals(base)
    return names


_ADD_STATE_LITERALS: Dict[type, set] = {}


def _add_state_literals(base: type) -> set:
    """The literal state names of the ``add_state`` calls in one class's source (cached)."""
    if base not in _ADD_STATE_LITERALS:
        names: set = set()
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(base)))
        except (OSError, TypeError, SyntaxError):
            tree = None
        for node in ast.walk(tree) if tree is not None else ():
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_state":
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names.add(arg.value)
        _ADD_STATE_LITERALS[base] = names
    return _ADD_STATE_LITERALS[base]


def class_findings(item: IntrospectedClass, repo_root: str) -> List[Finding]:
    """All state-contract findings for one introspected metric class."""
    from metrics_tpu_torch.core.metric import Metric
    from metrics_tpu_torch.core.state import CatBuffer

    findings: List[Finding] = []
    instance = item.instance
    if instance is None:
        return findings
    cls = item.cls
    anchor = _class_anchor(cls, repo_root)
    if anchor is None:
        return findings
    cls_path, cls_line = anchor

    defaults: Dict[str, Any] = dict(getattr(instance, "_defaults", {}))
    reductions: Dict[str, Any] = dict(getattr(instance, "_reductions", {}))
    exempt = set(getattr(cls, "_ckpt_exempt_attrs", ()) or ())
    sig_attrs = set(getattr(cls, "_update_signature_attrs", ()) or ())

    # ------------------------------------------------------ TM-STATE-UNREG
    fn, defining = _method_def(cls, "update")
    if fn is not None and defining is not Metric:
        declared = _declared_state_names(cls)
        def_anchor = _class_anchor(defining, repo_root)
        for attr, line in _update_self_assigns(fn):
            if attr in defaults or attr in _RUNTIME_ATTRS or attr in exempt or attr in declared:
                continue
            path = def_anchor[0] if def_anchor else cls_path
            findings.append(
                Finding(
                    rule="TM-STATE-UNREG",
                    path=path,
                    line=line,
                    col=0,
                    symbol=f"{defining.__name__}.update.{attr}",
                    message=(
                        f"`update` assigns `self.{attr}` but it was never registered via "
                        "add_state: it will not sync across hosts, survives reset(), and a "
                        "checkpoint restore silently recomputes from defaults (the "
                        "RASE/RMSE-SW lazy-init bug class)"
                    ),
                )
            )

    # -------------------------------------------------- TM-REDUCE-MISMATCH
    for state, reduce_fx in reductions.items():
        default = defaults.get(state)
        sym = f"{cls.__name__}.{state}"
        if reduce_fx == "cat" and not isinstance(default, (list, CatBuffer)):
            findings.append(
                Finding(
                    rule="TM-REDUCE-MISMATCH",
                    path=cls_path,
                    line=cls_line,
                    col=0,
                    symbol=sym,
                    message=(
                        f"state `{state}` declares dist_reduce_fx='cat' over a dense array "
                        "default: cat sync concatenates along dim 0, which changes the state "
                        "shape the ckpt manifest validates against"
                    ),
                )
            )
        elif reduce_fx in _ARRAY_REDUCTIONS and isinstance(default, list):
            findings.append(
                Finding(
                    rule="TM-REDUCE-MISMATCH",
                    path=cls_path,
                    line=cls_line,
                    col=0,
                    symbol=sym,
                    message=(
                        f"state `{state}` declares dist_reduce_fx='{reduce_fx}' over a list "
                        "default: element-wise reductions need a fixed-shape array state"
                    ),
                )
            )
        elif reduce_fx == "mean" and isinstance(default, torch.Tensor):
            dtype = default.dtype
            if not (dtype.is_floating_point or dtype.is_complex):
                findings.append(
                    Finding(
                        rule="TM-REDUCE-MISMATCH",
                        path=cls_path,
                        line=cls_line,
                        col=0,
                        symbol=sym,
                        message=(
                            f"state `{state}` declares dist_reduce_fx='mean' over integer dtype "
                            f"{dtype}: the cross-host mean (and the ckpt topology re-reduce) is "
                            "fractional and cannot be stored exactly"
                        ),
                    )
                )
        elif callable(reduce_fx) and not isinstance(reduce_fx, str):
            findings.append(
                Finding(
                    rule="TM-REDUCE-MISMATCH",
                    path=cls_path,
                    line=cls_line,
                    col=0,
                    symbol=sym,
                    message=(
                        f"state `{state}` uses a custom callable dist_reduce_fx: "
                        "ckpt/restore.py's topology re-reduce cannot honor it when restoring "
                        "onto a different rank count (only sum/mean/max/min/cat re-reduce)"
                    ),
                )
            )

    # ---------------------------------------------------------- TM-PERSIST
    # plain attributes and buffers registered outside add_state (a Metric is an
    # nn.Module: its tensor states are non-persistent buffers)
    attrs = {**vars(instance), **dict(getattr(instance, "_buffers", {}))}
    for attr, value in attrs.items():
        if attr in defaults or attr in _RUNTIME_ATTRS or attr in exempt or attr in sig_attrs:
            continue
        if isinstance(value, Metric):
            continue  # child metrics are serialized via ckpt child_metrics()
        if isinstance(value, (list, tuple)) and value and all(isinstance(v, Metric) for v in value):
            continue
        if callable(value):
            continue
        if _is_array_value(value):
            findings.append(
                Finding(
                    rule="TM-PERSIST",
                    path=cls_path,
                    line=cls_line,
                    col=0,
                    symbol=f"{cls.__name__}.{attr}",
                    message=(
                        f"tensor-valued attribute `self.{attr}` is outside the add_state "
                        "registry: ckpt/serializer.py silently drops it on save. Register it, "
                        "name it in `_update_signature_attrs` (ctor knob), or declare it in "
                        "`_ckpt_exempt_attrs`"
                    ),
                )
            )

    return findings


def run_contract_rules(repo_root: str, device: Any) -> Tuple[List[Finding], Dict[str, str]]:
    """(findings, {class_name: skip_reason}) over every introspectable class, built on ``device``."""
    from metrics_tpu_torch.analysis.registry import introspect_classes, introspect_fleet_variants

    findings: List[Finding] = []
    skipped: Dict[str, str] = {}
    seen_classes: set = set()
    for item in introspect_classes(device):
        if item.instance is None:
            skipped[item.name] = item.skip_reason
            continue
        if item.cls in seen_classes:
            continue  # dispatcher duplicates (Accuracy -> BinaryAccuracy)
        seen_classes.add(item.cls)
        findings.extend(class_findings(item, repo_root))
    # fleet-axis variants re-run the contract rules over a live (N, *base)
    # state registry — same classes, so any repeat finding collapses in the
    # key+line dedup below and only fleet-specific drift would surface
    for item in introspect_fleet_variants(device):
        if item.instance is None:
            skipped[item.name] = item.skip_reason
            continue
        findings.extend(class_findings(item, repo_root))
    # several exported classes share one defining update (AUROC inherits the
    # curve update): identical (key, line) findings collapse to one
    seen_keys = set()
    unique: List[Finding] = []
    for f in findings:
        k = f.key() + (f.line,)
        if k not in seen_keys:
            seen_keys.add(k)
            unique.append(f)
    return unique, skipped
