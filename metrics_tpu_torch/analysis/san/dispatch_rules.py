"""Dispatch-recording rules: TMS-CALLBACK, TMS-F64, TMS-UPCAST, TMS-BIGCONST,
TMS-COLLECTIVE (counterpart of ``metrics_tpu/analysis/san/jaxpr_rules.py``).

The JAX package walks the closed jaxpr of a metric's ``local_update``/``compute_from``
traced under abstract inputs. The port records the same ground truth while it traces:
``local_update`` and ``compute_from`` run on fake tensors (``FakeTensorMode``, nothing
executes, nothing is allocated) under :class:`DispatchRecorder`, a
``TorchDispatchMode`` that sees every dispatched op. Each op is put down to the
innermost frame of the analyzed package on the Python stack (``(path, line,
function)``), where jax's per-equation ``source_info`` gives the user frames. The
rules:

- **TMS-CALLBACK** — a host read: ``aten::_local_scalar_dense`` (``.item()``,
  ``float()``, ``bool()``), a copy from the card to the host, or a
  ``DataDependentOutputException`` (the runner adds those);
- **TMS-F64** — a float64 or complex128 op output in a trace whose inputs and states
  hold none (torch has no x64 switch);
- **TMS-BIGCONST** — a tensor made from host data inside the trace (``lift_fresh``, or a
  host-to-device ``_to_copy``/``copy_`` of a real CPU tensor) of 64 KiB or more;
- **TMS-COLLECTIVE** — a ``c10d``/``_c10d_functional`` op, or a ``torch.distributed``
  collective function (the runner's watch), reached from an update or compute;
- **TMS-UPCAST** — :func:`upcast_findings`, over the state dtypes of a bf16 re-trace.

The recorder also counts what the cost budget (``costs.py``) reads: each op's input
and output bytes, and the fake storage alive.
"""
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from metrics_tpu_torch.analysis.findings import Finding

#: host-read ops — a device-pure step must not dispatch these
CALLBACK_OPS = frozenset({"aten::_local_scalar_dense", "aten::item"})
#: op namespaces of the collectives
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
#: constants at or above this size are "baked in" findings (a capture holds a copy per key)
BIGCONST_BYTES = 1 << 16  # 64 KiB
#: the copies a host-to-device transfer dispatches as
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_"})
_LIFT_OPS = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy", "aten::lift"})

#: torch.linalg functions that check their result on the host (their ``_ex`` forms do not):
#: the card synchronises there, which a fake trace cannot run
_LINALG_CHECKED = frozenset({
    "solve", "inv", "cholesky", "lu_factor", "ldl_factor", "eigh", "eigvalsh", "eig", "eigvals", "svd", "svdvals",
    "pinv", "lstsq", "matrix_rank", "check_errors",
})

_WIDE_FLOATS = (torch.float64, torch.complex128)
_NARROW_FLOATS = (torch.bfloat16, torch.float16)
#: files of the analyzer itself are never evidence
_SELF_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class TraceAnchor:
    """Where findings for one traced entry are pinned (waiver-stable symbol)."""

    path: str  # repo-relative defining file of the traced entry
    line: int
    symbol: str  # "ClassName.update" / "ops.binary_auroc_exact"


@dataclass
class GraphFacts:
    """Everything one recorded trace yields (rules, crosscheck and costs)."""

    #: (op, repo_path, line, function) of each host read; path "" when no repo frame
    callbacks: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: (op, repo_path, line, function, onto_card) of each tensor made from host data in
    #: the trace (``lift_fresh``, a host-to-device copy): presence evidence for a waived
    #: host transfer, and a synchronising copy on the card when ``onto_card``
    transfers: List[Tuple[str, str, int, str, bool]] = field(default_factory=list)
    #: (op, repo_path, line, function) of each checked ``torch.linalg`` op: the card syncs there
    checks: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: (op, group, repo_path, line) of each collective
    collectives: List[Tuple[str, str, str, int]] = field(default_factory=list)
    #: (dtype, repo_path, line, op) of each float64 output
    f64s: List[Tuple[str, str, int, str]] = field(default_factory=list)
    #: (nbytes, shape, dtype, repo_path, line) of each big constant
    bigconsts: List[Tuple[int, Tuple[int, ...], str, str, int]] = field(default_factory=list)
    #: every repo (path, line) that ran in the trace: the footprint the crosscheck
    #: corroborates TM-HOSTSYNC waivers against
    footprint: Set[Tuple[str, int]] = field(default_factory=set)
    #: ops dispatched, and those that are the package's own custom ops (hand kernels)
    ops: int = 0
    kernel_ops: Dict[str, int] = field(default_factory=dict)
    #: bytes read and written by the dispatched ops (views excluded)
    bytes_accessed: float = 0.0
    #: the most bytes of storage made in the trace alive at once
    peak_bytes: float = 0.0


def _under(roots: Sequence[str], path: str) -> bool:
    absp = os.path.abspath(path)
    return not absp.startswith(_SELF_DIR + os.sep) and any(absp.startswith(r + os.sep) for r in roots)


def innermost_frame(roots: Sequence[str], repo_root: str, frame: Any = None) -> Tuple[str, int, str]:
    """``(repo-relative path, line, function)`` of the innermost frame under ``roots``
    (from ``frame`` outwards, default: the caller's), or ``("", 0, "")``."""
    frame = frame if frame is not None else sys._getframe(1)
    while frame is not None:
        if _under(roots, frame.f_code.co_filename):
            rel = os.path.relpath(os.path.abspath(frame.f_code.co_filename), repo_root).replace(os.sep, "/")
            return rel, frame.f_lineno, frame.f_code.co_name
        frame = frame.f_back
    return "", 0, ""


def traceback_frame(roots: Sequence[str], repo_root: str, tb: Any) -> Tuple[str, int, str]:
    """The innermost frame under ``roots`` of a traceback."""
    where = ("", 0, "")
    while tb is not None:
        if _under(roots, tb.tb_frame.f_code.co_filename):
            rel = os.path.relpath(os.path.abspath(tb.tb_frame.f_code.co_filename), repo_root).replace(os.sep, "/")
            where = (rel, tb.tb_lineno, tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    return where


def _is_fake(t: Any) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DispatchRecorder(TorchDispatchMode):
    """Records the rules' facts of every op dispatched in its body into ``facts``.
    Enter it after (inside) the ``FakeTensorMode``, so that it sees each op first."""

    def __init__(self, facts: GraphFacts, roots: Sequence[str], repo_root: str, wide_inputs: bool) -> None:
        super().__init__()
        self.facts = facts
        self.roots = list(roots)
        self.repo_root = repo_root
        self.wide_inputs = wide_inputs
        self._alive: Dict[int, List[int]] = {}  # storage id -> [bytes, tensors alive]
        self._alive_bytes = 0

    def _track(self, out: Any) -> None:
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor) or not _is_fake(t):
                continue
            key = t.untyped_storage()._cdata
            entry = self._alive.get(key)
            if entry is None:
                entry = self._alive[key] = [t.untyped_storage().nbytes(), 0]
                self._alive_bytes += entry[0]
                self.facts.peak_bytes = max(self.facts.peak_bytes, float(self._alive_bytes))
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._alive.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self._alive_bytes -= entry[0]
            del self._alive[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        facts = self.facts
        facts.ops += 1
        namespace = name.split("::", 1)[0]
        if namespace == "metrics_tpu_torch":
            facts.kernel_ops[name] = facts.kernel_ops.get(name, 0) + 1
        where: Optional[Tuple[str, int, str]] = None

        def at() -> Tuple[str, int, str]:
            nonlocal where
            if where is None:
                where = innermost_frame(self.roots, self.repo_root, sys._getframe())
            return where

        if name in CALLBACK_OPS:
            facts.callbacks.append((name, *at()))
        base = name.split("::", 1)[-1].lstrip("_")
        if base.startswith("linalg_") and base[len("linalg_"):] in _LINALG_CHECKED:
            facts.checks.append((name, *at()))
        if namespace in COLLECTIVE_NAMESPACES:
            path, line, _ = at()
            facts.collectives.append((name, "", path, line))
        tensors_in = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        # host data made into a tensor (real CPU data lifted or copied), and any copy of a
        # CPU tensor onto the card
        host = [t for t in tensors_in if not _is_fake(t) and t.device.type == "cpu"]
        made = host and (name in _LIFT_OPS or (name in _COPY_OPS and _copies_to_device(args, kwargs)))
        if made and _nbytes(host[0]) >= BIGCONST_BYTES:
            path, line, _ = at()
            facts.bigconsts.append((_nbytes(host[0]), tuple(host[0].shape), str(host[0].dtype).replace("torch.", ""),
                                    path, line))
        h2d = name in _COPY_OPS and any(t.device.type == "cpu" for t in tensors_in) and _copies_to_device(args, kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if made or h2d:
            facts.transfers.append((name, *at(), any(t.device.type == "cuda" for t in outs)))
        if name in _COPY_OPS and tensors_in and tensors_in[0].device.type == "cuda" and any(
                t.device.type == "cpu" for t in outs):
            facts.callbacks.append((f"{name} (device to host)", *at()))
        if not self.wide_inputs:
            for t in outs:
                if t.dtype in _WIDE_FLOATS:
                    path, line, _ = at()
                    facts.f64s.append((str(t.dtype).replace("torch.", ""), path, line, name))
                    break  # one report per op is enough
        view = any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
        if not view:
            facts.bytes_accessed += float(sum(_nbytes(t) for t in tensors_in) + sum(_nbytes(t) for t in outs))
        self._track(out)
        return out


def _copies_to_device(args: Any, kwargs: Dict[str, Any]) -> bool:
    """Is a ``_to_copy``/``copy_`` call one onto a CUDA device?"""
    device = kwargs.get("device")
    if device is None:
        device = next((a for a in args[1:] if isinstance(a, torch.device)), None)
    if device is None and len(args) > 1 and isinstance(args[0], torch.Tensor) and isinstance(args[1], torch.Tensor):
        device = args[0].device  # copy_(dst, src): dst's device
    return device is not None and torch.device(device).type == "cuda"


def wide_dtype_in(*trees: Any) -> bool:
    """Does any tensor of ``trees`` hold float64 or complex128?"""
    return any(isinstance(t, torch.Tensor) and t.dtype in _WIDE_FLOATS for t in pytree.tree_leaves(trees))


# ---------------------------------------------------------------------------
# findings from facts
# ---------------------------------------------------------------------------


def _mk(rule: str, anchor: TraceAnchor, path: str, line: int, message: str) -> Finding:
    return Finding(rule=rule, path=path or anchor.path, line=line or anchor.line, col=0, symbol=anchor.symbol,
                   message=message)


def findings_from_facts(facts: GraphFacts, anchor: TraceAnchor, case: str) -> List[Finding]:
    out: List[Finding] = []
    for op, path, line, func in facts.callbacks:
        where = f" (host code: {func})" if func else ""
        out.append(_mk("TMS-CALLBACK", anchor, path, line,
                       f"`{op}` in the traced graph of {anchor.symbol} [{case}]{where}: the step reads the "
                       "card on the host on EVERY execution (a capture of it fails)"))
    for op, group, path, line in facts.collectives:
        grp = f" over group `{group}`" if group else ""
        out.append(_mk("TMS-COLLECTIVE", anchor, path, line,
                       f"collective `{op}`{grp} reachable from the trace of {anchor.symbol} [{case}]: a rank "
                       "that calls the update alone deadlocks the others — collectives belong in "
                       "Metric.sync/sync_state"))
    for dt, path, line, op in facts.f64s:
        out.append(_mk("TMS-F64", anchor, path, line,
                       f"{dt} value (op `{op}`) in the traced graph of {anchor.symbol} [{case}], whose inputs "
                       "and states hold none: 2x the bytes and float64 arithmetic on the card"))
    for nbytes, shape, dt, path, line in facts.bigconsts:
        out.append(_mk("TMS-BIGCONST", anchor, path, line,
                       f"constant {dt}{list(shape)} ({nbytes} B >= {BIGCONST_BYTES} B) made from host data in "
                       f"the trace of {anchor.symbol} [{case}]: copied to the card every eager step and baked "
                       "into every captured graph — build it on the card once, or pass it as an input"))
    # one finding per (rule, message): the same hazard at two shapes is one triage
    seen: Set[Tuple[str, str]] = set()
    unique: List[Finding] = []
    for f in out:
        k = (f.rule, f.message.replace(f"[{case}]", ""))
        if k not in seen:
            seen.add(k)
            unique.append(f)
    return unique


def upcast_findings(in_state: Dict[str, Any], out_state: Dict[str, Any], anchor: TraceAnchor,
                    case: str) -> List[Finding]:
    """TMS-UPCAST: declared (input) against produced (output) state dtypes of the bf16
    re-trace. A state leaf that enters update as bf16/f16 and leaves as float32 or
    float64 breaks the dtype half of the state contract."""
    out: List[Finding] = []
    in_leaves = dict(_leaves_by_path(in_state))
    for key, leaf_out in _leaves_by_path(out_state):
        leaf_in = in_leaves.get(key)
        if leaf_in is None:
            continue
        din, dout = getattr(leaf_in, "dtype", None), getattr(leaf_out, "dtype", None)
        if din in _NARROW_FLOATS and dout not in _NARROW_FLOATS and dout is not None and (
                dout.is_floating_point or dout.is_complex):
            out.append(_mk(
                "TMS-UPCAST", anchor, "", 0,
                f"state `{key}` enters update as {str(din).replace('torch.', '')} but leaves as "
                f"{str(dout).replace('torch.', '')} [{case}]: a float32 tensor constant in the accumulation "
                "promotes the declared state dtype (2x the bytes; ckpt DtypeDriftError on restore). Use Python "
                "scalars or cast back with .to(<state>.dtype)"))
    return out


def _leaves_by_path(tree: Any) -> List[Tuple[str, Any]]:
    flat, _ = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out.append((key, leaf))
    return out
