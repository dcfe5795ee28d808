"""AST rules over trace-reachable code: TM-HOSTSYNC, TM-PYBRANCH, TM-DYNSHAPE,
TM-RETRACE (counterpart of ``metrics_tpu/analysis/trace_rules.py``, in torch terms).

These run only on functions the trace-boundary model (jitmap.py) marked
reachable from a traced step, and only on statements on the traced side of the
port's concreteness guards:

- TM-HOSTSYNC: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``float/int/bool/complex(tensor)``, ``torch.equal``/``allclose`` (a host bool),
  ``torch.cuda.synchronize()``, and numpy calls on tensors;
- TM-PYBRANCH: ``if``/``while``/``assert`` on tensor values (an implicit
  ``Tensor.__bool__``);
- TM-DYNSHAPE: ``torch.unique``/``unique_consecutive``/``nonzero``/``argwhere``/
  ``masked_select`` (functions and methods), one-argument ``torch.where``,
  boolean-mask indexing, and ``repeat_interleave`` with tensor repeats and no
  ``output_size=``;
- TM-RETRACE (every function): ``torch.compile`` built inside a function body,
  and Python scalars flowing into a module-level ``torch.compile`` alias or into
  a step-cache key (the ``tag`` and ``static_key`` of ``core/fleet.py:run_step``).

Precision heuristics, as in the JAX module:

- a small per-function *static-name* dataflow pass marks locals derived from
  shapes/lengths/literals (``n = preds.shape[0]``; ``m = _next_pow2(int(n))``)
  so ``int(n)`` padding arithmetic is not a host sync;
- parameters annotated with Python scalar types (``int``, ``float``, ``bool``,
  ``str``, ``Optional[int]`` …) are static;
- numpy calls are exempt when the callee is a dtype/const helper or every
  argument is static (``np.prod(shape)``).
"""
import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.jitmap import (
    FuncInfo,
    ModuleModel,
    dotted_name,
    iter_trace_regions,
)

#: numpy attributes that produce static/python values (or are type objects)
_NP_STATIC = {
    "dtype", "finfo", "iinfo", "result_type", "promote_types", "issubdtype",
    "ndarray", "generic", "number", "integer", "floating", "complexfloating",
    "bool_", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "longdouble", "complex64",
    "complex128", "isscalar", "ndim", "shape", "size", "newaxis", "errstate",
    "RandomState", "random",
}
#: torch functions whose results are static python values (safe in branch tests)
_TORCH_STATIC = {
    "is_tensor", "is_floating_point", "is_complex", "is_nonzero_static", "is_grad_enabled",
    "is_inference_mode_enabled", "get_default_dtype", "finfo", "iinfo", "promote_types", "result_type",
    "can_cast", "numel", "device", "Size", "dtype", "are_deterministic_algorithms_enabled",
    "is_autocast_enabled", "get_num_threads", "is_storage", "_profiler_enabled",
}
#: torch sub-namespaces of host state (device queries, process groups, flags)
_TORCH_HOST_NAMESPACES = {
    "cuda", "distributed", "jit", "_C", "backends", "compiler", "_dynamo", "library", "version", "utils",
    "testing", "overrides", "_utils", "hub", "multiprocessing", "profiler",
}
#: tensor attributes that are static under a trace
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "itemsize", "is_cuda", "layout", "requires_grad", "is_sparse"}
#: tensor methods whose results are static python values
_STATIC_METHODS = {
    "size", "dim", "ndimension", "numel", "nelement", "element_size", "is_floating_point", "is_complex",
    "is_contiguous", "stride", "get_device", "data_ptr", "storage_offset", "is_signed",
}
#: tensor methods that copy a value to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: torch functions that return a host bool (a sync)
_HOST_BOOL_FNS = {"equal", "allclose"}
#: dynamic-output-shape torch functions / tensor methods
_DYNSHAPE_FNS = {"unique", "unique_consecutive", "nonzero", "argwhere", "masked_select"}
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}
_HOST_CASTS = {"float", "int", "bool", "complex"}
_DTYPE_NAMES = {
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128", "half", "float", "double", "long",
    "int", "short", "cfloat", "cdouble",
}
#: torch functions that copy their data argument to ``device=`` (a host-to-device copy
#: when the data is a Python or numpy value): {name: position of device}
_H2D_FNS = {"tensor": None, "as_tensor": 2, "asarray": None}
#: torch.linalg functions that check their result on the host (their ``_ex`` forms do not)
_LINALG_CHECKED = {
    "solve", "inv", "cholesky", "lu_factor", "ldl_factor", "eigh", "eigvalsh", "eig", "eigvals", "svd", "svdvals",
    "pinv", "lstsq", "matrix_rank",
}
#: step-cache entry points: {function name: positional indices that enter the key}
_STEP_KEY_CALLS = {"run_step": (1,)}


def _annotation_is_scalar(node: Optional[ast.expr]) -> bool:
    if node is None:
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _SCALAR_ANNOTATIONS:
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and sub.value in _SCALAR_ANNOTATIONS:
            return True
    return False


def _annotation_names(node: Optional[ast.expr]) -> Set[str]:
    """The last components of the names an annotation mentions (``np.ndarray`` -> ``ndarray``)."""
    if node is None:
        return set()
    return {(dotted_name(sub) or "").split(".")[-1] for sub in ast.walk(node) if isinstance(sub, (ast.Name, ast.Attribute))}


def _annotation_is_numpy(node: Optional[ast.expr]) -> bool:
    """``np.ndarray``: a host array, whose reads are no device sync."""
    return "ndarray" in _annotation_names(node) and "Tensor" not in _annotation_names(node)


def _annotation_is_host_array(node: Optional[ast.expr]) -> bool:
    """``List[...]`` / ``Sequence[...]`` / ``Tuple[...]``: host containers (of values or tensors)."""
    return bool(_annotation_names(node) & {"List", "list", "Sequence", "Tuple", "tuple"})


def _is_torch_host_call(module: ModuleModel, parts: List[str]) -> bool:
    """``torch.is_tensor(...)``, ``torch.cuda.*(...)``: a static host value."""
    if not parts or parts[0] not in module.torch_aliases:
        return False
    if len(parts) >= 3 and parts[1] in _TORCH_HOST_NAMESPACES:
        return True
    return parts[-1] in _TORCH_STATIC or parts[-1] in _DTYPE_NAMES


def _bound_names(func: ast.AST) -> Set[str]:
    """Every local name a function binds: its parameters and assignment targets."""
    out: Set[str] = set()
    args = getattr(func, "args", None)
    if args is not None:
        for a in list(args.args) + list(args.kwonlyargs) + list(getattr(args, "posonlyargs", [])):
            out.add(a.arg)
        for a in (args.vararg, args.kwarg):
            if a is not None:
                out.add(a.arg)
    for node in ast.walk(func):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _module_statics(module: ModuleModel) -> Set[str]:
    """Module-level names bound only to static values (``_SEED_BOUND = 2**63 - 1``)."""
    cached = getattr(module, "_static_globals", None)
    if cached is not None:
        return cached
    statics = _StaticNames(None, module, cls=None, module_level=True)
    static: Set[str] = set()
    dynamic: Set[str] = set()
    for stmt in module.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = list(stmt.targets), stmt.value
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets, value = [stmt.target], stmt.value
        for target in targets:
            for el in ast.walk(target):
                if isinstance(el, ast.Name):
                    ok = value is not None and statics.is_static(value)
                    (static if ok else dynamic).add(el.id)
                    if ok:
                        statics.names.add(el.id)
    module._static_globals = static - dynamic
    return module._static_globals


def _module_names(module: ModuleModel) -> Set[str]:
    """Every name bound at module level (constants, caches, imports)."""
    cached = getattr(module, "_global_names", None)
    if cached is None:
        cached = module._global_names = {
            n.id for stmt in module.tree.body if not isinstance(stmt, (ast.FunctionDef, ast.ClassDef))
            for n in ast.walk(stmt) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
        }
    return cached


def _class_statics(module: ModuleModel, cls: Optional[str]) -> Set[str]:
    """Attributes of class ``cls`` that only ever hold static values: every
    ``self.<attr> = ...`` in its methods (and ``<attr> = ...`` in its body) assigns a
    static expression, e.g. ``self.num_bins = num_bins`` from an ``int`` parameter."""
    if cls is None:
        return set()
    cache = getattr(module, "_static_attrs", None)
    if cache is None:
        cache = module._static_attrs = {}
    if cls in cache:
        return cache[cls]
    cache[cls] = set()  # no recursion through the class's own attributes
    static: Set[str] = set()
    dynamic: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            body_statics = _StaticNames(None, module, cls=None, module_level=True)
            for stmt in node.body:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value is not None:
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    for t in targets:
                        if isinstance(t, ast.Name):
                            (static if body_statics.is_static(stmt.value) else dynamic).add(t.id)
    for info in module.functions.values():
        if info.cls != cls or not isinstance(info.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        local = _StaticNames(info.node, module, cls=None)
        for node in ast.walk(info.node):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for el in ([t] if not isinstance(t, (ast.Tuple, ast.List)) else list(t.elts)):
                        if isinstance(el, ast.Attribute) and isinstance(el.value, ast.Name) and el.value.id == "self":
                            ok = (node.value is not None and not isinstance(t, (ast.Tuple, ast.List))
                                  and local.is_static(node.value))
                            (static if ok else dynamic).add(el.attr)
    cache[cls] = static - dynamic
    return cache[cls]


class _StaticNames:
    """Per-function set of names known to hold static (non-tensor) values: scalar-
    annotated parameters, names assigned static expressions, the module's static
    constants (where the function does not rebind the name) and the static
    attributes of the enclosing class (``self.num_bins``)."""

    def __init__(self, func: Optional[ast.AST], module: ModuleModel, cls: Optional[str] = None,
                 module_level: bool = False) -> None:
        self.module = module
        self.func = func
        self.names: Set[str] = set()
        self.host_names: Set[str] = set()  # params annotated as numpy arrays or Python containers
        if module_level or func is None:
            self.globals: Set[str] = set()
            self.attrs: Set[str] = set()
            return
        self.globals = _module_statics(module) - _bound_names(func)
        self.attrs = _class_statics(module, cls)
        args = getattr(func, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs) + list(getattr(args, "posonlyargs", [])):
                if _annotation_is_scalar(a.annotation) or _annotation_is_numpy(a.annotation):
                    self.names.add(a.arg)
                elif _annotation_is_host_array(a.annotation):
                    self.host_names.add(a.arg)
        # one forward pass: assignments of static expressions create static names
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name) and self.is_static(node.value):
                    self.names.add(target.id)
                elif isinstance(target, ast.Tuple) and self.is_static(node.value):
                    # e.g. `_, c, h, w = x.shape` — every unpacked name is static
                    for el in target.elts:
                        if isinstance(el, ast.Name):
                            self.names.add(el.id)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                if node.value is not None and self.is_static(node.value):
                    self.names.add(node.target.id)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
                # comprehension vars over a static iterable are static
                for gen in node.generators:
                    if self.is_static(gen.iter) and isinstance(gen.target, ast.Name):
                        self.names.add(gen.target.id)

    def is_static(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            if node.id in self.names or node.id in self.globals:
                return True
            # bare from-imports of dtype/type objects: `from numpy import float32`
            imported = self.module.imports.get(node.id, "")
            if ":" in imported:
                srcmod, _, orig = imported.partition(":")
                if srcmod == "numpy" and orig in _NP_STATIC:
                    return True
                if srcmod == "torch" and (orig in _TORCH_STATIC or orig in _DTYPE_NAMES):
                    return True
            return False
        if isinstance(node, ast.Attribute):
            # x.shape / x.ndim / x.dtype / x.device are static under a trace
            if node.attr in _STATIC_ATTRS:
                return True
            if isinstance(node.value, ast.Name) and node.value.id == "self" and node.attr in self.attrs:
                return True
            # np.int32 / torch.float32 used as dtype arguments are type objects
            if isinstance(node.value, ast.Name):
                if node.value.id in self.module.np_aliases:
                    return node.attr in _NP_STATIC
                if node.value.id in self.module.torch_aliases:
                    return node.attr in _TORCH_STATIC or node.attr in _DTYPE_NAMES
            return False
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.is_static(e) for e in node.elts)
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) and self.is_static(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, ast.IfExp):
            return self.is_static(node.body) and self.is_static(node.orelse)
        if isinstance(node, ast.Compare):
            return self.is_static(node.left) and all(self.is_static(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _STATIC_METHODS:
                    return True  # x.numel(), x.size(0), x.dim()
                if not self._is_module(dotted_name(node.func)):
                    # a method of a value that may be a tensor is not static (``x.to(dtype)``);
                    # a method of a static (host) value over static arguments is (``host.max()``)
                    return self.is_static(node.func.value) and all(self.is_static(a) for a in node.args) and all(
                        self.is_static(k.value) for k in node.keywords if k.value is not None)
            name = dotted_name(node.func)
            if name is None:
                return False
            parts = name.split(".")
            last = parts[-1]
            if last == "len":
                return True
            base = parts[0]
            if base in self.module.np_aliases:
                return last in _NP_STATIC or all(self.is_static(a) for a in node.args)
            if base in self.module.torch_aliases:
                return _is_torch_host_call(self.module, parts)
            # local helper over static args (e.g. _next_pow2(int(n)))
            return bool(node.args or node.keywords) and all(
                self.is_static(a) for a in node.args
            ) and all(self.is_static(k.value) for k in node.keywords if k.value is not None)
        return False


    def _is_module(self, name: Optional[str]) -> bool:
        """Is ``name`` (``np.zeros``, ``_rank.helper``) a function of an imported name?"""
        base = name.split(".")[0] if name else None
        return base is not None and (
            base in self.module.imports or base in self.module.np_aliases or base in self.module.torch_aliases)


def _call_kwarg_names(call: ast.Call) -> Set[str]:
    return {k.arg for k in call.keywords if k.arg}


class _RuleVisitor(ast.NodeVisitor):
    """Expression-level rules for one trace-reachable statement."""

    def __init__(
        self,
        module: ModuleModel,
        symbol: str,
        statics: _StaticNames,
        findings: List[Finding],
        skip_tests: Set[int],
    ) -> None:
        self.module = module
        self.symbol = symbol
        self.statics = statics
        self.findings = findings
        self.skip_tests = skip_tests  # node ids of guard-bearing branch tests
        #: names known not to be tensors here (the else side of ``isinstance(x, Tensor)``)
        self.host_values: Set[str] = set()
        self.bound = _bound_names(statics.func) if statics.func is not None else set()

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=rule,
                path=self.module.path,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                symbol=self.symbol,
                message=message,
            )
        )

    # ------------------------------------------------------- TM-PYBRANCH

    def _test_is_traced(self, test: ast.expr) -> Optional[ast.AST]:
        """First sub-expression proving the branch test depends on tensor data.

        Recursive rather than ``ast.walk``: sub-expressions whose *consumed*
        value is static — ``x.dtype``, ``torch.is_floating_point(x)``, shape
        attributes — must not count as evidence.
        """

        def probe(node: ast.AST) -> Optional[ast.AST]:
            if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
                return None  # static attribute of whatever it hangs off
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and node.func.attr in _STATIC_METHODS:
                    return None
                name = dotted_name(node.func)
                parts = name.split(".") if name else []
                if parts and parts[0] in self.module.torch_aliases:
                    if _is_torch_host_call(self.module, parts):
                        return None  # torch.is_floating_point(...) etc. give host bools
                    return node
                if (
                    parts
                    and parts[-1] in ("any", "all", "item", "equal", "allclose")
                    and isinstance(node.func, ast.Attribute)
                    and not self.statics.is_static(node.func.value)
                ):
                    return node
            for child in ast.iter_child_nodes(node):
                found = probe(child)
                if found is not None:
                    return found
            return None

        return probe(test)

    def check_branch(self, stmt: ast.stmt) -> bool:
        """Returns True when the statement's test needs no further linting."""
        test = getattr(stmt, "test", None)
        if test is None or id(test) in self.skip_tests:
            return True  # guard test: exempt, and don't lint its sub-expressions
        kind = {ast.If: "if", ast.While: "while", ast.Assert: "assert"}[type(stmt)]
        evidence = self._test_is_traced(test)
        if evidence is not None:
            what = dotted_name(getattr(evidence, "func", evidence)) or "tensor expression"
            self._emit(
                "TM-PYBRANCH",
                stmt,
                f"`{kind}` branches on a tensor value ({what}(...)): an implicit bool() sync "
                "that a capture refuses; use torch.where or an `_is_concrete` guard",
            )
            return True  # one finding per branch; skip HOSTSYNC echoes in the test
        return False

    # -------------------------------------------------------------- calls

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        func = node.func
        name = dotted_name(func)
        module_fn = self.statics._is_module(name)

        if isinstance(func, ast.Attribute) and not module_fn and not self.statics.is_static(func.value):
            # .item() / .tolist() / .cpu() / .numpy() on anything non-static
            if func.attr in _HOST_METHODS and not node.args:
                self._emit(
                    "TM-HOSTSYNC",
                    node,
                    f"`.{func.attr}()` forces a device->host sync inside a trace-reachable region",
                )
                return
            # .to("cpu") / .to(device="cpu")
            if func.attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in list(node.args) + [k.value for k in node.keywords if k.arg == "device"]
            ):
                self._emit("TM-HOSTSYNC", node, "`.to(\"cpu\")` copies to the host inside a trace-reachable region")
                return
            if func.attr in _HOST_BOOL_FNS:
                self._emit("TM-HOSTSYNC", node, f"`.{func.attr}(...)` reads a host bool (a device sync)")
                return
            if func.attr in _DYNSHAPE_FNS:
                self._emit(
                    "TM-DYNSHAPE",
                    node,
                    f"`.{func.attr}()` has a data-dependent output shape (the card reports the size "
                    "to the host); use a padded ops/ kernel or `torch.where(cond, x, fill)`",
                )
                return
            if func.attr == "repeat_interleave":
                self._check_repeat_interleave(node, node.args[0] if node.args else None)
                return
            if func.attr in ("to", "cuda") and self._moves_host_tensor(node):
                self._emit(
                    "TM-HOSTSYNC",
                    node,
                    f"`.{func.attr}(...)` moves a host tensor to the device: a pageable host-to-device "
                    "copy that synchronises (a capture refuses it)",
                )
                return

        # float()/int()/bool() on non-static values
        if isinstance(func, ast.Name) and func.id in _HOST_CASTS and len(node.args) == 1:
            if not self.statics.is_static(node.args[0]):
                self._emit(
                    "TM-HOSTSYNC",
                    node,
                    f"`{func.id}()` on a tensor value reads it on the host (a device sync); "
                    "keep it a tensor or mark the operand static",
                )
            return

        if name is None:
            return
        parts = name.split(".")
        base, last = parts[0], parts[-1]

        # bare-name from-imports: `from numpy import asarray` / `from torch import
        # nonzero` hide the module prefix the dotted checks key on — resolve them
        # through the import table
        if len(parts) == 1:
            imported = self.module.imports.get(base, "")
            if ":" in imported:
                srcmod, _, orig = imported.partition(":")
                if srcmod == "numpy":
                    parts = [base, orig]
                    last = orig
                elif srcmod == "torch":
                    parts, last = ["torch", orig], orig
                    base = "torch"

        # numpy compute calls
        if base in self.module.np_aliases and len(parts) >= 2:
            if last not in _NP_STATIC and not (
                node.args and all(self.statics.is_static(a) for a in node.args)
            ):
                self._emit(
                    "TM-HOSTSYNC",
                    node,
                    f"numpy call `{name}(...)` materializes on the host inside a trace-reachable "
                    "region; use torch, or guard the host path with `_is_concrete`",
                )
            return

        is_torch = base in self.module.torch_aliases or base == "torch"
        if not is_torch:
            return
        if name.endswith("cuda.synchronize"):
            self._emit("TM-HOSTSYNC", node, "`torch.cuda.synchronize()` is an explicit host sync")
            return
        if last in _HOST_BOOL_FNS and len(parts) == 2:
            self._emit("TM-HOSTSYNC", node, f"`{name}(...)` returns a host bool (a device sync)")
            return
        if len(parts) == 3 and parts[1] == "linalg" and last in _LINALG_CHECKED:
            self._emit(
                "TM-HOSTSYNC",
                node,
                f"`{name}` checks its result on the host (a device sync); use the `_ex` form where "
                "there is one (`solve_ex`, `inv_ex`, `cholesky_ex`), which leaves the check to the caller",
            )
            return
        if len(parts) != 2:
            return
        if last in _H2D_FNS and self._check_h2d(node, name, _H2D_FNS[last]):
            return
        # dynamic shapes
        if last in _DYNSHAPE_FNS:
            self._emit(
                "TM-DYNSHAPE",
                node,
                f"`{name}` has a data-dependent output shape (the card reports the size to the "
                "host); use a padded ops/ kernel or `torch.where(cond, x, fill)`",
            )
            return
        if last == "where":
            if len(node.args) == 1 and not node.keywords:
                self._emit(
                    "TM-DYNSHAPE",
                    node,
                    "single-argument `torch.where(cond)` is `nonzero` (data-dependent shape); "
                    "use the three-argument select form",
                )
            return
        if last == "repeat_interleave":
            # torch.repeat_interleave(input, repeats) or the one-argument torch.repeat_interleave(repeats)
            single = len(node.args) == 1 and "repeats" not in _call_kwarg_names(node)
            self._check_repeat_interleave(node, node.args[1] if len(node.args) > 1 else None, single)

    def _moves_host_tensor(self, node: ast.Call) -> bool:
        """``torch.from_numpy(a).to(device)`` / ``torch.tensor(v).cuda()``."""
        recv = node.func.value
        if not isinstance(recv, ast.Call):
            return False
        name = dotted_name(recv.func) or ""
        parts = name.split(".")
        if len(parts) != 2 or parts[0] not in self.module.torch_aliases:
            return False
        if parts[1] == "from_numpy":
            pass
        elif parts[1] in ("tensor", "as_tensor") and recv.args and self._is_host_data(recv.args[0]):
            if self._device_arg(recv, _H2D_FNS[parts[1]]) is not None:
                return False  # made on its device already (flagged there if it copies)
        else:
            return False
        if node.func.attr == "cuda":
            return True
        targets = [k.value for k in node.keywords if k.arg == "device"] + list(node.args[:1])
        for t in targets:
            if isinstance(t, ast.Constant):
                if isinstance(t.value, str) and t.value != "cpu":
                    return True
                continue
            if self.statics.is_static(t) and not (isinstance(t, ast.Attribute) and t.attr == "device"):
                continue  # a dtype: a cast on the host
            return True
        return False

    def _check_repeat_interleave(self, node: ast.Call, repeats: Optional[ast.expr], single: bool = False) -> None:
        """``repeat_interleave`` with tensor repeats and no ``output_size=`` syncs."""
        if "output_size" in _call_kwarg_names(node):
            return
        if repeats is None and not single:
            repeats = next((k.value for k in node.keywords if k.arg == "repeats"), None)
        if single or (repeats is not None and not self.statics.is_static(repeats)):
            self._emit(
                "TM-DYNSHAPE",
                node,
                "`repeat_interleave` with tensor repeats and no `output_size=` has a "
                "data-dependent length; pass `output_size=`",
            )

    # ------------------------------------------------ host-to-device copies

    def _is_host_data(self, data: ast.expr) -> bool:
        """Is ``data`` a value on the host (Python numbers or containers, numpy arrays)?"""
        if isinstance(data, (ast.List, ast.Tuple, ast.ListComp, ast.Dict)):
            return True  # a list of Python values, or of tensors that are read one by one
        if self.statics.is_static(data):
            return True
        if isinstance(data, ast.Name):
            return data.id in self.statics.host_names or data.id in self.host_values
        if isinstance(data, ast.Call):
            name = dotted_name(data.func)
            if name in ("float", "int", "bool", "complex"):  # a Python number of constants: float("-inf")
                return all(isinstance(a, ast.Constant) or self.statics.is_static(a) for a in data.args)
            return bool(name) and name.split(".")[0] in self.module.np_aliases
        if isinstance(data, ast.Subscript) and isinstance(data.value, ast.Name):
            # an entry of a module-level cache (``_CACHE[key]``)
            return data.value.id in _module_names(self.module) and data.value.id not in self.bound
        return False

    def _device_arg(self, node: ast.Call, position: Optional[int]) -> Optional[ast.expr]:
        for kw in node.keywords:
            if kw.arg == "device":
                return kw.value
        if position is not None and len(node.args) > position:
            return node.args[position]
        return None

    def _check_h2d(self, node: ast.Call, name: str, device_position: Optional[int]) -> bool:
        """``torch.tensor(host data, device=...)``: a pageable host-to-device copy, which
        synchronises and which a capture refuses."""
        device = self._device_arg(node, device_position)
        if device is None or (isinstance(device, ast.Constant) and device.value == "cpu"):
            return False
        data = node.args[0] if node.args else next((k.value for k in node.keywords if k.arg == "data"), None)
        if data is None or not self._is_host_data(data):
            return False
        self._emit(
            "TM-HOSTSYNC",
            node,
            f"`{name}(...)` copies host data to the device: a pageable host-to-device copy that "
            "synchronises (a capture refuses it); make the value on the device (`torch.full`, "
            "`torch.arange`) or once, outside the step",
        )
        return True

    def visit_IfExp(self, node: ast.IfExp) -> None:
        hit = _isinstance_tensor(node.test)
        host = hit[0] if hit and hit[1] else None
        self.visit(node.test)
        self.visit(node.body)
        if host is None or host in self.host_values:
            self.visit(node.orelse)
            return
        self.host_values.add(host)
        try:
            self.visit(node.orelse)
        finally:
            self.host_values.discard(host)

    # ------------------------------------------------- boolean-mask indexing

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self.generic_visit(node)
        sl = node.slice
        if isinstance(sl, ast.Compare) and not self.statics.is_static(sl):
            self._emit(
                "TM-DYNSHAPE",
                node,
                "boolean-mask indexing `x[cond]` has a data-dependent shape; use "
                "`torch.where(cond, x, fill)` or a padded kernel",
            )


def run_retrace_rules(module: ModuleModel, info: FuncInfo) -> List[Finding]:
    """TM-RETRACE: compiled wrappers built per call + python scalars into compiled
    aliases and step-cache keys.

    Unlike the trace-safety rules, these scan EVERY function: the hazard lives
    at the host-side call site feeding a compiled step, which is usually not
    itself trace-reachable."""
    findings: List[Finding] = []
    _check_retrace(module, info, findings)
    return findings


def _check_retrace(
    module: ModuleModel,
    info: FuncInfo,
    findings: List[Finding],
) -> None:
    node = info.node
    is_setup = info.qualname in module.module_level_only
    fargs = getattr(node, "args", None)
    scalar_params = {
        a.arg for a in (fargs.args if fargs is not None else []) if _annotation_is_scalar(a.annotation)
    }

    def flag(arg_node: ast.expr, into: str) -> None:
        for sub in ast.walk(arg_node):
            if isinstance(sub, ast.Name) and sub.id in scalar_params:
                findings.append(
                    Finding(
                        rule="TM-RETRACE",
                        path=module.path,
                        line=sub.lineno,
                        col=sub.col_offset,
                        symbol=info.qualname,
                        message=(
                            f"python scalar `{sub.id}` flows into {into} as a fresh constant per "
                            "call: every new value is a new capture or compile (obs counters: "
                            "<MetricClass>.retraces / .retrace_signatures, fused.cache_misses). "
                            "Pass it as a tensor (torch.as_tensor)"
                        ),
                    )
                )
                return

    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue

        # (a) torch.compile(...) constructed inside a function body
        if module._is_compile(sub.func):
            name = dotted_name(sub.func) or "compile"
            if not is_setup:
                findings.append(
                    Finding(
                        rule="TM-RETRACE",
                        path=module.path,
                        line=sub.lineno,
                        col=sub.col_offset,
                        symbol=info.qualname,
                        message=(
                            f"`{name}(...)` constructed inside `{info.qualname}`: a fresh "
                            "wrapper per call starts with an empty cache — build it at "
                            "module scope (obs counter: fused.cache_misses)"
                        ),
                    )
                )
            continue

        if not isinstance(sub.func, (ast.Name, ast.Attribute)):
            continue
        callee = sub.func.id if isinstance(sub.func, ast.Name) else sub.func.attr

        # (b) python-scalar params entering a step-cache key
        if callee in _STEP_KEY_CALLS:
            for i in _STEP_KEY_CALLS[callee]:
                if i < len(sub.args):
                    flag(sub.args[i], f"the step-cache key of `{callee}`")
            for kw in sub.keywords:
                if kw.arg in ("tag", "static_key"):
                    flag(kw.value, f"the step-cache key of `{callee}`")
            continue

        # (c) python-scalar params flowing into a module-level torch.compile alias
        if not isinstance(sub.func, ast.Name):
            continue
        alias = module.jit_aliases.get(sub.func.id)
        if alias is None or alias.dynamic:
            continue
        for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
            if isinstance(arg, ast.Name):
                flag(arg, f"compiled `{alias.name}` (a guard on its value)")


def _isinstance_tensor(test: ast.expr) -> Optional[Tuple[str, bool]]:
    """``(name, True)`` for ``isinstance(name, Tensor)``, ``(name, False)`` for its negation."""
    negated = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    call = test.operand if negated else test
    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name) and call.func.id == "isinstance"
            and len(call.args) == 2 and isinstance(call.args[0], ast.Name)
            and (dotted_name(call.args[1]) or "").split(".")[-1] == "Tensor"):
        return call.args[0].id, not negated
    return None


def _host_value_scopes(body: Sequence[ast.stmt], known: frozenset = frozenset()) -> Dict[int, frozenset]:
    """For each statement, the names it may take for non-tensors: inside ``if not
    isinstance(x, Tensor):`` (or the ``else`` of ``if isinstance(x, Tensor):``) ``x`` is not
    a tensor."""
    out: Dict[int, frozenset] = {}
    for stmt in body:
        out[id(stmt)] = known
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(stmt, ast.If):
            hit = _isinstance_tensor(stmt.test)
            body_known = known | {hit[0]} if hit and not hit[1] else known
            else_known = known | {hit[0]} if hit and hit[1] else known
            out.update(_host_value_scopes(stmt.body, body_known))
            out.update(_host_value_scopes(stmt.orelse, else_known))
            continue
        for sub in (getattr(stmt, "body", None), getattr(stmt, "orelse", None), getattr(stmt, "finalbody", None)):
            if sub:
                out.update(_host_value_scopes(sub, known))
        for handler in getattr(stmt, "handlers", ()) or ():
            out.update(_host_value_scopes(handler.body, known))
    return out


def run_trace_rules(module: ModuleModel, info: FuncInfo) -> List[Finding]:
    """All trace-safety findings for one trace-reachable function."""
    findings: List[Finding] = []
    node = info.node
    statics = _StaticNames(node, module, info.cls)

    if isinstance(node, ast.Lambda):
        visitor = _RuleVisitor(module, info.qualname, statics, findings, set())
        visitor.visit(node.body)
        return findings

    regions = list(iter_trace_regions(node.body))
    skip_tests: Set[int] = set()
    for stmt, _traced, lint_test in regions:
        if not lint_test:
            test = getattr(stmt, "test", None)
            if test is not None:
                skip_tests.add(id(test))

    visitor = _RuleVisitor(module, info.qualname, statics, findings, skip_tests)
    host_scopes = _host_value_scopes(node.body)
    for stmt, traced, _lint_test in regions:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue  # nested defs are separate symbols (rooted independently)
        if not traced:
            continue
        visitor.host_values = set(host_scopes.get(id(stmt), ()))
        if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
            handled = visitor.check_branch(stmt)
            test = getattr(stmt, "test", None)
            if not handled and test is not None:
                visitor.visit(test)
            if isinstance(stmt, ast.Assert) and stmt.msg is not None:
                visitor.visit(stmt.msg)
            continue
        # visit only this statement's own expressions, not nested blocks
        # (nested block statements appear as their own region entries)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                visitor.visit(child)
            elif isinstance(child, ast.withitem):
                visitor.visit(child.context_expr)

    seen = set()
    unique: List[Finding] = []
    for f in findings:
        k = (f.rule, f.path, f.line, f.col, f.symbol)
        if k not in seen:
            seen.add(k)
            unique.append(f)
    return unique
