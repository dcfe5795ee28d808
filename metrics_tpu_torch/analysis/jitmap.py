"""The trace-boundary model of the port: which code is reachable from a traced step.

Counterpart of ``metrics_tpu/analysis/jitmap.py``. A host read is only a fault
where it can run *inside a traced step*: in the port that is a CUDA graph capture
(``core/fused.py:CapturedStep``, where a host read makes the capture fail and the
group is demoted to eager), a ``torch.func`` transform (the fleet's ``vmap``, the
stacked wrappers), or the engines' eager plain step on the CPU, run inside
``utils/checks.py:tracing()``. This module builds, per package, the set of
(module, function) pairs reachable from such an entry, where entries are:

1. **decorators** — ``@torch.compile`` and the ``torch.func`` transforms used as
   decorators,
2. **call sites** — ``torch.func.vmap(f)`` / ``torch.vmap(f)`` and the other
   ``torch.func`` transforms, ``torch.compile(f)``, the step compilers
   ``CapturedStep(step, ...)`` / ``compile_step(step, ...)``, and the batching
   rules registered with ``torch.library.register_vmap(name, rule)``
   (``ops/histogram.py``, ``ops/segment.py``, ``ops/rank.py``), at module level
   and inside function bodies, including targets wrapped in ``functools.partial``
   and lambdas,
3. **traced blocks** — the calls made inside ``with tracing():`` and
   ``with torch.cuda.graph(...):`` bodies (the engines' steps),
4. **the ``Metric._wrap_update`` entry** — every registered ``Metric`` subclass's
   ``update``/``compute`` body (injected by the runner from introspection; classes
   that declare ``_host_side_update = True`` are host code by contract and are not
   entries),
5. **step factories** — a local function whose *parameter* is called inside a
   rooted inner function marks the argument at each call site as an entry.

Reachability then propagates through the call graph — across modules of the
analyzed package via import resolution — but **only through trace-reachable
statements**: the port's concreteness guards partition a function body into
traced and host-only regions. ``_is_concrete(...)`` is False inside a traced
step; ``in_step()``, ``torch.cuda.is_current_stream_capturing()``,
``torch._C._are_functorch_transforms_active()`` and ``is_batchedtensor(x)`` are
True there. Calls made from host-only regions do not propagate: unlike the JAX
model's edge walk, a compound statement contributes only its own header (an
``if`` test, a ``for`` iterable, a ``with`` item), never the calls of a guarded
body.
"""
import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: callables that trace their function argument (``torch.func`` transforms, ``torch.compile``)
_TRACING_WRAPPERS = {
    "vmap", "grad", "grad_and_value", "jacrev", "jacfwd", "hessian", "jvp", "vjp", "functionalize", "compile",
}
#: module prefixes a tracing wrapper must come from (``re.compile`` is not one)
_TRACING_MODULES = ("torch", "functorch")
#: step compilers and rule registrations: {name: positions of traced function args (None = all)}
_TRACING_COMBINATORS = {
    "CapturedStep": (0,),
    "compile_step": (0,),
    "_EagerStep": (0,),
    "make_graphed_callables": (0,),
    "register_vmap": (1,),
}
#: functions recognized as concreteness guards (utils/checks.py idiom): False when traced
_CONCRETE_GUARDS = {"_is_concrete", "is_concrete"}
#: predicates that are True inside a traced step
_TRACED_PREDICATES = {
    "in_step", "is_current_stream_capturing", "_are_functorch_transforms_active", "is_batchedtensor",
}


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.func.vmap' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminates(body: Sequence[ast.stmt]) -> bool:
    """Whether falling out of ``body`` is impossible (ends in return/raise/...)."""
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _terminates(last.body) and _terminates(last.orelse)
    return False


def _guard_value(call: ast.Call) -> Optional[bool]:
    """Value of one guard call inside a traced step, None if it is not a guard."""
    name = dotted_name(call.func)
    last = name.split(".")[-1] if name else None
    if last in _CONCRETE_GUARDS:
        return False
    if last in _TRACED_PREDICATES:
        return True
    return None


def tracing_truth(test: ast.expr) -> Optional[bool]:
    """Value of a guard expression *inside a traced step*: True/False when decidable.

    ``_is_concrete(...)`` is False there; the traced predicates are True. Boolean
    combinations fold through and/or/not; anything else is None (unknown).
    """
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = tracing_truth(test.operand)
        return None if inner is None else (not inner)
    if isinstance(test, ast.BoolOp):
        vals = [tracing_truth(v) for v in test.values]
        if isinstance(test.op, ast.And):
            if any(v is False for v in vals):
                return False
            if all(v is True for v in vals):
                return True
        else:  # Or
            if any(v is True for v in vals):
                return True
            if all(v is False for v in vals):
                return False
        return None
    if isinstance(test, ast.Call):
        return _guard_value(test)
    return None


def _has_guard(test: ast.expr) -> bool:
    """Whether the test mentions a concreteness guard at all (then the test
    expression itself must not be linted: its data-dependent sub-expressions
    only evaluate on the concrete side of a short-circuit)."""
    return any(isinstance(node, ast.Call) and _guard_value(node) is not None for node in ast.walk(test))


def iter_trace_regions(body: Sequence[ast.stmt], traced: bool = True) -> Iterable[Tuple[ast.stmt, bool, bool]]:
    """Yield ``(stmt, traced, lint_test)`` for every statement, guard-aware.

    ``traced`` is False for statements only reachable on the concrete (eager)
    side of a guard. ``lint_test`` is False for If statements whose test
    contains a guard call (the test short-circuits on concreteness and must
    not be linted). Nested function/class defs are NOT entered — they are
    separate symbols with their own reachability.
    """
    traced_now = traced
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield stmt, traced_now, True  # callers may want the def site itself
            continue
        if isinstance(stmt, ast.If):
            truth = tracing_truth(stmt.test)
            yield stmt, traced_now, not _has_guard(stmt.test)
            if truth is True:
                # tracing enters the body; orelse is eager-only
                yield from iter_trace_regions(stmt.body, traced_now)
                yield from iter_trace_regions(stmt.orelse, False)
                if _terminates(stmt.body):
                    traced_now = False  # the rest only runs eagerly
            elif truth is False:
                # tracing skips the body
                yield from iter_trace_regions(stmt.body, False)
                yield from iter_trace_regions(stmt.orelse, traced_now)
                if stmt.orelse and _terminates(stmt.orelse):
                    traced_now = False
            else:
                yield from iter_trace_regions(stmt.body, traced_now)
                yield from iter_trace_regions(stmt.orelse, traced_now)
            continue
        yield stmt, traced_now, True
        for sub in (
            getattr(stmt, "body", None),
            getattr(stmt, "orelse", None),
            getattr(stmt, "finalbody", None),
        ):
            if sub:
                yield from iter_trace_regions(sub, traced_now)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from iter_trace_regions(handler.body, traced_now)
        for case in getattr(stmt, "cases", ()) or ():
            yield from iter_trace_regions(case.body, traced_now)


def own_expressions(stmt: ast.AST) -> List[ast.AST]:
    """The expressions a statement evaluates itself: all of a simple statement,
    only the header of a compound one (its nested blocks are statements of their
    own in :func:`iter_trace_regions`)."""
    if isinstance(stmt, ast.If) or isinstance(stmt, ast.While):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, (ast.Try, ast.TryStar)):
        return []
    if isinstance(stmt, ast.Match):
        return [stmt.subject]
    return [stmt]


def _is_traced_block(stmt: ast.stmt) -> bool:
    """``with tracing():`` / ``with torch.cuda.graph(...):`` (alone or among other items)."""
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return False
    for item in stmt.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func) or ""
            if name == "tracing" or name.endswith(".tracing") or name.endswith("cuda.graph"):
                return True
    return False


@dataclass
class FuncInfo:
    qualname: str
    node: ast.AST  # FunctionDef | Lambda
    lineno: int
    cls: Optional[str] = None  # enclosing class name, if a method
    #: symbols called from trace-reachable statements (resolved in phase B)
    edges: Set[str] = field(default_factory=set)
    #: params that escape into a traced inner region (step-factory pattern)
    escaping_params: Set[str] = field(default_factory=set)


@dataclass
class JitAlias:
    """Module-level ``X = torch.compile(f, ...)`` binding (the JAX package's jit alias)."""

    name: str
    target: Optional[str]  # qualname of the wrapped local function, if known
    #: ``torch.compile(..., dynamic=True)``: scalar arguments are symbolic, not guards
    dynamic: bool = False
    lineno: int = 0


class ModuleModel:
    """Per-file AST model: functions, imports, trace entries, call edges."""

    def __init__(self, path: str, modname: str, source: str) -> None:
        self.path = path
        self.modname = modname
        self.tree = ast.parse(source)
        self.functions: Dict[str, FuncInfo] = {}
        self.imports: Dict[str, str] = {}  # local name -> "module" | "module:symbol"
        self.np_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        self.jit_aliases: Dict[str, JitAlias] = {}
        self.roots: Dict[str, str] = {}  # qualname -> reason
        #: (symbol, enclosing class, reason) called inside traced blocks, resolved package-wide
        self.traced_calls: List[Tuple[str, Optional[str], str]] = []
        #: local functions whose only call sites are module-level statements
        #: (setup/factory helpers run once at import; compile-in-body is fine there)
        self.module_level_only: Set[str] = set()
        self._collect()

    # ------------------------------------------------------------ phase A

    def _collect(self) -> None:
        self._walk_scope(self.tree.body, prefix="", cls=None, at_module_level=True)
        for info in list(self.functions.values()):
            self._scan_body_entries(info)
        self._detect_factories()

    def _add_function(self, node: ast.AST, qualname: str, cls: Optional[str]) -> FuncInfo:
        info = FuncInfo(qualname=qualname, node=node, lineno=node.lineno, cls=cls)
        self.functions[qualname] = info
        return info

    def _walk_scope(self, body: Sequence[ast.stmt], prefix: str, cls: Optional[str], at_module_level: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                self._record_import(stmt)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + stmt.name
                self._add_function(stmt, qual, cls)
                self._scan_decorators(stmt, qual)
                self._walk_scope(stmt.body, prefix=qual + ".", cls=cls, at_module_level=False)
            elif isinstance(stmt, ast.ClassDef):
                self._walk_scope(stmt.body, prefix=prefix + stmt.name + ".", cls=stmt.name, at_module_level=False)
            elif at_module_level and isinstance(stmt, ast.Assign):
                self._scan_module_assign(stmt)
        if at_module_level:
            # trace entries referenced from arbitrary module-level expressions
            for stmt in body:
                if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    self._scan_calls_for_entries(stmt)

    def _record_import(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                local = alias.asname or alias.name.split(".")[0]
                self.imports[local] = alias.name
                if alias.name == "numpy" or alias.name.startswith("numpy."):
                    self.np_aliases.add(local)
                if alias.name == "torch" or (alias.asname is None and alias.name.startswith("torch.")):
                    self.torch_aliases.add(local)
        elif isinstance(stmt, ast.ImportFrom) and stmt.module:
            for alias in stmt.names:
                local = alias.asname or alias.name
                if stmt.module == "numpy":
                    self.np_aliases.add(local)
                self.imports[local] = f"{stmt.module}:{alias.name}"

    def _from_torch(self, base: str) -> bool:
        """Whether a local name comes from torch (``torch``, ``from torch import func``)."""
        if base in self.torch_aliases:
            return True
        target = self.imports.get(base, "")
        return target.split(":")[0].split(".")[0] in _TRACING_MODULES

    # -- trace entry detection -----------------------------------------------

    def _is_tracing_wrapper(self, func: ast.expr) -> bool:
        name = dotted_name(func)
        if not name:
            return False
        parts = name.split(".")
        if parts[-1] not in _TRACING_WRAPPERS:
            return False
        return self._from_torch(parts[0])

    def _is_compile(self, func: ast.expr) -> bool:
        name = dotted_name(func)
        return bool(name) and name.split(".")[-1] == "compile" and self._is_tracing_wrapper(func)

    def _combinator_positions(self, func: ast.expr) -> Optional[Tuple[Optional[Tuple[int, ...]], str]]:
        name = dotted_name(func)
        if not name:
            return None
        last = name.split(".")[-1]
        if last in _TRACING_COMBINATORS:
            return _TRACING_COMBINATORS[last], last
        return None

    def _mark_entry_expr(self, node: ast.expr, reason: str) -> None:
        """Mark the function referenced by an expression as a trace entry."""
        if isinstance(node, ast.Name):
            for qual in self.functions:
                if qual == node.id or qual.endswith("." + node.id):
                    self.roots.setdefault(qual, reason)
            return
        if isinstance(node, ast.Lambda):
            qual = f"<lambda@{node.lineno}>"
            if qual not in self.functions:
                self._add_function(node, qual, None)
            self.roots.setdefault(qual, reason)
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name and name.split(".")[-1] == "partial":
                if node.args:
                    self._mark_entry_expr(node.args[0], reason)
                return
            # nested wrapper: torch.compile(torch.func.vmap(f))
            if self._is_tracing_wrapper(node.func) and node.args:
                self._mark_entry_expr(node.args[0], reason)
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name and name.startswith("self."):
                # method references: self._kernel passed to vmap
                for qual in self.functions:
                    if qual.endswith("." + node.attr):
                        self.roots.setdefault(qual, "method passed to a tracing wrapper")

    def _scan_decorators(self, node: ast.AST, qual: str) -> None:
        for dec in getattr(node, "decorator_list", ()):
            target = dec.func if isinstance(dec, ast.Call) else dec
            if self._is_tracing_wrapper(target):
                self.roots.setdefault(qual, f"decorated by a tracing wrapper at line {dec.lineno}")
            elif isinstance(dec, ast.Call):
                name = dotted_name(dec.func)
                if name and name.split(".")[-1] == "partial" and dec.args:
                    if self._is_tracing_wrapper(dec.args[0]):
                        self.roots.setdefault(qual, f"decorated @partial(<transform>) at line {dec.lineno}")

    def _scan_calls_for_entries(self, root: ast.AST) -> None:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            if self._is_tracing_wrapper(node.func) and node.args:
                self._mark_entry_expr(node.args[0], f"passed to a tracing wrapper at line {node.lineno}")
                continue
            comb = self._combinator_positions(node.func)
            if comb is not None:
                positions, cname = comb
                args = node.args
                idxs = range(len(args)) if positions is None else [p for p in positions if p < len(args)]
                for i in idxs:
                    self._mark_entry_expr(args[i], f"traced by {cname} at line {node.lineno}")

    def _scan_body_entries(self, info: FuncInfo) -> None:
        """Entries made inside a function body: tracing wrappers and step compilers
        called there, and the calls of its traced blocks."""
        node = info.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        for stmt in _own_statements(node.body):
            for expr in own_expressions(stmt):
                self._scan_calls_for_entries(expr)
            if _is_traced_block(stmt):
                for inner in _own_statements(stmt.body):
                    for expr in own_expressions(inner):
                        for call in ast.walk(expr):
                            if not isinstance(call, ast.Call):
                                continue
                            reason = f"called in a traced block of {info.qualname} (line {stmt.lineno})"
                            if isinstance(call.func, ast.Name):
                                self._mark_entry_expr(call.func, reason)
                                self.traced_calls.append((call.func.id, info.cls, reason))
                            else:
                                name = dotted_name(call.func)
                                if name and name.startswith("self."):
                                    self._mark_entry_expr(call.func, reason)
                                elif name:
                                    self.traced_calls.append((name, info.cls, reason))

    def _scan_module_assign(self, stmt: ast.Assign) -> None:
        """Record ``X = torch.compile(f, dynamic=...)`` aliases."""
        if not (isinstance(stmt.value, ast.Call) and len(stmt.targets) == 1):
            return
        target = stmt.targets[0]
        if not isinstance(target, ast.Name):
            return
        call = stmt.value
        if not self._is_compile(call.func):
            return
        dynamic = any(
            kw.arg == "dynamic" and isinstance(kw.value, ast.Constant) and kw.value.value is True
            for kw in call.keywords
        )
        wrapped: Optional[str] = None
        if call.args:
            inner = call.args[0]
            if isinstance(inner, ast.Name) and inner.id in self.functions:
                wrapped = inner.id
            elif isinstance(inner, ast.Call):
                name = dotted_name(inner.func)
                if name and name.split(".")[-1] == "partial" and inner.args:
                    first = inner.args[0]
                    if isinstance(first, ast.Name) and first.id in self.functions:
                        wrapped = first.id
        self.jit_aliases[target.id] = JitAlias(name=target.id, target=wrapped, dynamic=dynamic, lineno=stmt.lineno)

    # -- step factories ------------------------------------------------------

    def _detect_factories(self) -> None:
        """A param called inside a rooted inner function escapes into the trace;
        call-site args at that position become entries. Also classifies which
        local functions are only ever called from module level (setup helpers —
        exempt from compile-in-body linting)."""
        for qual, info in self.functions.items():
            node = info.node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in node.args.args]
            if not params:
                continue
            inner_rooted = [
                self.functions[q].node
                for q in self.roots
                if q.startswith(qual + ".") and q in self.functions
            ]
            called: Set[str] = set()
            for inner in inner_rooted:
                for sub in ast.walk(inner):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        called.add(sub.func.id)
            info.escaping_params = {p for p in params if p in called}

        # a function is a "setup helper" only when it IS called at module level and
        # NOT from any function body; never-called functions stay lintable
        called_from_funcs: Set[str] = set()
        for qual, info in self.functions.items():
            node = info.node
            body = node.body if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else [ast.Expr(node.body)]
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        called_from_funcs.add(sub.func.id)
        called_at_module: Set[str] = set()
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                    called_at_module.add(sub.func.id)
        for qual in self.functions:
            base = qual.split(".")[-1]
            if base in called_at_module and base not in called_from_funcs:
                self.module_level_only.add(qual)

        # factory call sites at module level
        for stmt in self.tree.body:
            for node in ast.walk(stmt):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
                    continue
                factory = self.functions.get(node.func.id)
                if factory is None or not factory.escaping_params:
                    continue
                fnode = factory.node
                if not isinstance(fnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                params = [a.arg for a in fnode.args.args]
                for i, arg in enumerate(node.args):
                    if i < len(params) and params[i] in factory.escaping_params:
                        self._mark_entry_expr(arg, f"escapes into a trace via factory {factory.qualname} (line {node.lineno})")
                for kw in node.keywords:
                    if kw.arg in factory.escaping_params:
                        self._mark_entry_expr(kw.value, f"escapes into a trace via factory {factory.qualname} (line {node.lineno})")

    # ------------------------------------------------------------ edges

    def collect_edges(self) -> None:
        """Record, per function, the symbols called from trace-reachable code."""
        for qual, info in self.functions.items():
            node = info.node
            if isinstance(node, ast.Lambda):
                exprs: List[ast.AST] = [node.body]
            else:
                exprs = [
                    expr
                    for stmt, traced, _ in iter_trace_regions(node.body)
                    if traced and not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    for expr in own_expressions(stmt)
                ]
            for expr in exprs:
                for sub in ast.walk(expr):
                    if not isinstance(sub, ast.Call):
                        continue
                    if isinstance(sub.func, ast.Name):
                        info.edges.add(sub.func.id)
                    else:
                        name = dotted_name(sub.func)
                        if name:
                            info.edges.add(name)
            # method calls via self resolve on the enclosing class
            info.edges = {e[5:] if e.startswith("self.") else e for e in info.edges}


def _own_statements(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Every statement of a body and its nested blocks, nested defs excluded."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield stmt
        for sub in (getattr(stmt, "body", None), getattr(stmt, "orelse", None), getattr(stmt, "finalbody", None)):
            if sub:
                yield from _own_statements(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from _own_statements(handler.body)
        for case in getattr(stmt, "cases", ()) or ():
            yield from _own_statements(case.body)


# ---------------------------------------------------------------- package level


class PackageModel:
    """All ModuleModels of one analyzed tree + cross-module reachability."""

    def __init__(self, files: Dict[str, Tuple[str, str]]) -> None:
        """``files``: {repo_relative_path: (modname, source)}."""
        self.modules: Dict[str, ModuleModel] = {}
        self.errors: Dict[str, str] = {}
        for path, (modname, source) in files.items():
            try:
                self.modules[path] = ModuleModel(path, modname, source)
            except SyntaxError as err:  # lint must not die on one bad file
                self.errors[path] = f"SyntaxError: {err}"
        self.by_modname = {m.modname: m for m in self.modules.values()}
        for m in self.modules.values():
            m.collect_edges()
        #: (path, qualname) -> reason, filled by propagate()
        self.reachable: Dict[Tuple[str, str], str] = {}

    def inject_roots(self, extra: Dict[str, Dict[str, str]]) -> None:
        """``{repo_relative_path: {qualname: reason}}`` — introspection entries."""
        for path, quals in extra.items():
            module = self.modules.get(path)
            if module is None:
                continue
            for qual, reason in quals.items():
                if qual in module.functions:
                    module.roots.setdefault(qual, reason)
                else:
                    # tolerate minor qualname drift (nested class etc.): suffix match
                    for cand in module.functions:
                        if cand.endswith("." + qual) or cand.split(".", 1)[-1] == qual:
                            module.roots.setdefault(cand, reason)
                            break

    def _class_bases(self, module: ModuleModel, cls: str) -> List[Tuple[ModuleModel, str]]:
        """The (module, class name) of each base of ``cls`` that the package defines."""
        out: List[Tuple[ModuleModel, str]] = []
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for base in node.bases:
                    name = dotted_name(base)
                    if not name:
                        continue
                    if "." not in name and any(isinstance(n, ast.ClassDef) and n.name == name for n in module.tree.body):
                        out.append((module, name))
                        continue
                    imported = module.imports.get(name.split(".")[0], "")
                    if ":" in imported:
                        modname, _, orig = imported.partition(":")
                        other = self.by_modname.get(modname)
                        if other is not None:
                            out.append((other, orig))
        return out

    def _resolve_method(self, module: ModuleModel, cls: str, symbol: str,
                        seen: Optional[Set[Tuple[str, str]]] = None) -> Optional[Tuple[ModuleModel, str]]:
        """``self.<symbol>`` of class ``cls``: its own method, else the nearest base's."""
        seen = set() if seen is None else seen
        if (module.path, cls) in seen:
            return None
        seen.add((module.path, cls))
        if f"{cls}.{symbol}" in module.functions:
            return module, f"{cls}.{symbol}"
        for base_mod, base in self._class_bases(module, cls):
            hit = self._resolve_method(base_mod, base, symbol, seen)
            if hit is not None:
                return hit
        return None

    def _resolve(self, module: ModuleModel, symbol: str, cls: Optional[str],
                 caller: Optional[str] = None) -> Optional[Tuple[ModuleModel, str]]:
        """Resolve a called symbol to (module, qualname) within the package."""
        # a nested def called from the function that defines it (or a sibling)
        prefix = caller
        while prefix and "." not in symbol:
            if f"{prefix}.{symbol}" in module.functions:
                return module, f"{prefix}.{symbol}"
            prefix = prefix.rpartition(".")[0]
        # method on the same class, or inherited from a base the package defines
        if cls is not None:
            hit = self._resolve_method(module, cls, symbol)
            if hit is not None:
                return hit
        if symbol in module.functions:
            return module, symbol
        if symbol in module.jit_aliases:
            target = module.jit_aliases[symbol].target
            if target and target in module.functions:
                return module, target
            return None
        if "." in symbol:
            base, _, attr = symbol.partition(".")
            target_mod = module.imports.get(base)
            if target_mod:
                if ":" in target_mod:
                    # `from metrics_tpu_torch.ops import rank as _rank` records
                    # "metrics_tpu_torch.ops:rank" — the imported symbol may itself
                    # be a module of the analyzed package
                    m, _, nm = target_mod.partition(":")
                    sub = self.by_modname.get(f"{m}.{nm}")
                    if sub:
                        return self._resolve(sub, attr, None)
                    return None
                other = self.by_modname.get(target_mod)
                if other:
                    return self._resolve(other, attr, None)
            return None
        imported = module.imports.get(symbol)
        if imported and ":" in imported:
            modname, _, name = imported.partition(":")
            other = self.by_modname.get(modname)
            if other:
                return self._resolve(other, name, None)
        return None

    def propagate(self) -> None:
        """BFS the call graph from all entries, trace-reachable edges only."""
        queue: List[Tuple[ModuleModel, str, str]] = []
        for module in self.modules.values():
            for qual, reason in module.roots.items():
                queue.append((module, qual, reason))
            for symbol, cls, reason in module.traced_calls:
                resolved = self._resolve(module, symbol[5:] if symbol.startswith("self.") else symbol, cls)
                if resolved is not None:
                    queue.append((resolved[0], resolved[1], reason))
        while queue:
            module, qual, reason = queue.pop()
            key = (module.path, qual)
            if key in self.reachable:
                continue
            self.reachable[key] = reason
            info = module.functions.get(qual)
            if info is None:
                continue
            for edge in info.edges:
                resolved = self._resolve(module, edge, info.cls, qual)
                if resolved is None:
                    continue
                tmod, tqual = resolved
                queue.append((tmod, tqual, f"called from {module.modname}:{qual}"))

    def reachable_functions(self) -> Iterable[Tuple[ModuleModel, FuncInfo, str]]:
        for (path, qual), reason in sorted(self.reachable.items()):
            module = self.modules[path]
            info = module.functions.get(qual)
            if info is not None:
                yield module, info, reason


def load_package(root: str, repo_root: str) -> Dict[str, Tuple[str, str]]:
    """Collect ``{repo_relative_path: (modname, source)}`` for a tree or file."""
    out: Dict[str, Tuple[str, str]] = {}
    paths: List[str] = []
    if os.path.isfile(root):
        paths = [root]
    elif os.path.isdir(root):
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__",))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    paths.append(os.path.join(dirpath, fn))
    else:
        raise FileNotFoundError(f"no such file or directory: {root}")
    for path in paths:
        rel = os.path.relpath(os.path.abspath(path), repo_root).replace(os.sep, "/")
        mod = rel[:-3].replace("/", ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        with open(path, "r", encoding="utf-8") as fh:
            out[rel] = (mod, fh.read())
    return out
