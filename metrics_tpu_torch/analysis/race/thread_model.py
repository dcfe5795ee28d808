"""The thread-role model: who runs what, holding which locks (a copy of
``metrics_tpu/analysis/race/thread_model.py``; its device syncs are torch's).

Phase A parses every module of the analyzed tree into a
:class:`RaceModuleModel`: functions (including methods and nested defs), lock
objects (module globals and ``self._x = threading.Lock()`` instance attrs),
thread spawns, handler installs, and the ``@thread_role``/``@locked_by``
annotation vocabulary (``metrics_tpu_torch/utils/concurrency.py``). Phase B links
the package: a cross-module class index, a call graph with attribute-typed
method resolution (``self._ring.drain()`` resolves through the
``self._ring = Ring(...)`` constructor assignment), role propagation from the
seeds, and the held-at-entry fixpoint.

Identity schemes (stable across line churn — baseline symbols build on them):

- locks:   ``ClassName._attr`` for instance locks, ``module._GLOBAL`` for
  module-level locks (module = last dotted component).
- targets: ``ClassName.attr`` / ``module.GLOBAL``; a constant-string subscript
  refines it (``IngestQueue.stats[ticks]``) so disjoint counter keys governed
  by different locks don't alias.
- roles:   the thread ``name=`` prefix when literal (``tm-ingest``,
  ``metrics-tpu-ckpt``), else the target qualname; ``user`` for the public
  API surface; ``signal``/``atexit``/``excepthook`` for handler installs.

Atomicity model (the documented GIL idioms, so ``obs/ring.py`` never FPs):
a single attribute/subscript *store* is atomic; ``deque.append`` and
``Event.set/clear`` are atomic; read-modify-write (``+=``, self-referencing
assigns) and multi-step container surgery (``extend``/``remove``/``pop``/
``clear``/``update``/...) are not.
"""
import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.jitmap import dotted_name

#: threading constructors that create a lock-like object (identity tracked)
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
#: constructors whose methods are GIL-atomic signals, never lock-like
_EVENT_CTORS = {"Event"}

#: container methods that mutate the receiver (non-atomic unless excepted)
_MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "add", "discard",
    "setdefault", "sort", "reverse", "rotate",
}
#: (receiver type, method) pairs modeled as one GIL-atomic bytecode-ish op
_ATOMIC_MUTCALLS = {
    ("deque", "append"), ("deque", "appendleft"), ("list", "append"),
    ("set", "add"), ("set", "discard"),
}

#: dotted suffixes that block on host IO / device sync (TMR-HOLD-HOST)
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep",
    "os.fsync": "disk fsync",
    "os.listdir": "disk listdir",
    "os.scandir": "disk scandir",
    "os.makedirs": "disk makedirs",
    "os.replace": "disk rename",
    "os.rename": "disk rename",
    "os.remove": "disk unlink",
    "os.unlink": "disk unlink",
    "os.rmdir": "disk rmdir",
    "os.path.isfile": "disk stat",
    "os.path.isdir": "disk stat",
    "os.path.exists": "disk stat",
    "os.path.getsize": "disk stat",
    "shutil.rmtree": "disk rmtree",
    "shutil.copy": "disk copy",
    "shutil.copytree": "disk copy",
    "subprocess.run": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
    "json.dump": "disk json.dump",
    "json.load": "disk json.load",
    "torch.cuda.synchronize": "device sync",
}
#: bare-name blocking calls
_BLOCKING_NAMES = {"open": "file open"}
#: attribute-method blocking calls (matched on the final attr)
_BLOCKING_ATTRS = {"synchronize": "device sync"}
#: numpy asarray on (possibly) device values forces a device->host transfer
_ASARRAY_FUNCS = {"asarray", "array"}

_HANDLER_KINDS = ("signal", "atexit", "excepthook")


# --------------------------------------------------------------------- records


@dataclass
class LockDecl:
    """One lock object: identity, kind, and where it was created."""

    lock_id: str
    kind: str  # Lock | RLock | Condition | Semaphore | BoundedSemaphore
    path: str
    line: int


@dataclass
class Acquire:
    """One acquisition site (``with lock:`` or ``lock.acquire()``)."""

    lock_id: str
    line: int
    col: int
    blocking: bool  # False for acquire(blocking=False) / acquire(False)
    held: Tuple[str, ...]  # locks already held locally at this point


@dataclass
class Mutation:
    """One write to a shared target (instance attr or module global)."""

    target: str
    line: int
    col: int
    kind: str  # store | rmw | augassign | mutcall:<name> | delete
    atomic: bool
    held: Tuple[str, ...]  # locks held locally at the write


@dataclass
class CallSite:
    symbol: str  # as written: "f", "self._apply", "mod.g", "obj.method"
    recv_type: Optional[str]  # inferred receiver type for obj.method calls
    line: int
    col: int
    held: Tuple[str, ...]


@dataclass
class BlockingOp:
    what: str  # human label ("disk listdir", "device sync", ...)
    expr: str  # the call as written
    line: int
    col: int
    held: Tuple[str, ...]


@dataclass
class SpawnSite:
    target_symbol: Optional[str]  # "write" | "self._loop" | None (unresolved)
    role: str  # thread-name prefix or target qualname
    daemon: bool
    joined: bool  # a .join() path exists for the stored handle
    line: int
    col: int


@dataclass
class HandlerInstall:
    kind: str  # signal | atexit | excepthook
    target_symbol: Optional[str]
    line: int


@dataclass
class RaceFunc:
    """Per-function facts, line-anchored for findings."""

    qualname: str
    modname: str
    path: str
    line: int
    cls: Optional[str]
    public: bool
    acquires: List[Acquire] = field(default_factory=list)
    mutations: List[Mutation] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    blocking_ops: List[BlockingOp] = field(default_factory=list)
    spawns: List[SpawnSite] = field(default_factory=list)
    declared_roles: Tuple[str, ...] = ()
    declared_locks: Tuple[str, ...] = ()  # @locked_by contract
    # filled by the package linker:
    roles: Set[str] = field(default_factory=set)
    entry_held: Optional[frozenset] = None  # None == top (unconstrained)


# --------------------------------------------------------------- module model


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _name_prefix(node: ast.AST) -> Optional[str]:
    """Literal prefix of a thread-name expression: ``f"tm-ingest/{x}"`` ->
    ``tm-ingest`` (separators stripped), plain strings verbatim."""
    text: Optional[str] = None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value
    elif isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            text = first.value
    if not text:
        return None
    return text.rstrip("/-_. {") or None


class RaceModuleModel:
    """Phase A: one file's threading facts."""

    def __init__(self, path: str, modname: str, source: str) -> None:
        self.path = path
        self.modname = modname
        self.short = modname.split(".")[-1]
        self.tree = ast.parse(source)
        self.imports: Dict[str, str] = {}
        self.module_locks: Dict[str, LockDecl] = {}  # global name -> decl
        self.module_globals: Set[str] = set()  # names assigned at module level
        self.module_global_types: Dict[str, str] = {}  # ctor-inferred types
        #: ClassName -> {attr: LockDecl}
        self.class_locks: Dict[str, Dict[str, LockDecl]] = {}
        #: ClassName -> {attr: type name} (constructor-inferred)
        self.class_attr_types: Dict[str, Dict[str, str]] = {}
        self.functions: Dict[str, RaceFunc] = {}
        self.handler_installs: List[HandlerInstall] = []
        self._collect()

    # ------------------------------------------------------------- phase A

    def _collect(self) -> None:
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                self._record_import(stmt)
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                self._record_module_assign(stmt)
        self._walk_defs(self.tree.body, prefix="", cls=None)
        # handler installs can live anywhere (enable(), module level, ...)
        for node in ast.walk(self.tree):
            self._scan_handler_install(node)
        for func in self.functions.values():
            self._analyze_function(func)

    def _record_import(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                local = alias.asname or alias.name.split(".")[0]
                self.imports[local] = alias.name
        elif isinstance(stmt, ast.ImportFrom) and stmt.module:
            for alias in stmt.names:
                local = alias.asname or alias.name
                self.imports[local] = f"{stmt.module}:{alias.name}"

    def _lock_ctor_kind(self, call: ast.expr) -> Optional[str]:
        """'Lock' for ``threading.Lock()`` / imported ``Lock()``; None else."""
        if not isinstance(call, ast.Call):
            return None
        name = dotted_name(call.func)
        if not name:
            return None
        last = name.split(".")[-1]
        if last == "Condition":
            return "Condition"
        if last in _LOCK_CTORS:
            base = name.split(".")[0]
            imported = self.imports.get(base, "")
            if "." in name and (base == "threading" or imported.startswith("threading")):
                return last
            if "." not in name and self.imports.get(name, "").startswith("threading"):
                return last
        return None

    def _ctor_type(self, value: ast.expr) -> Optional[str]:
        """Type name when ``value`` is ``SomeName(...)`` / ``mod.SomeName(...)``."""
        if not isinstance(value, ast.Call):
            return None
        name = dotted_name(value.func)
        if not name:
            return None
        last = name.split(".")[-1]
        if last in _EVENT_CTORS:
            return "Event"
        if last == "Thread":
            return "Thread"
        if last in ("deque", "set", "dict", "list"):
            return last
        return last if last[:1].isupper() else None

    def _record_module_assign(self, stmt: ast.stmt) -> None:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        value = stmt.value
        for target in targets:
            if isinstance(target, ast.Name):
                self.module_globals.add(target.id)
                if value is not None:
                    kind = self._lock_ctor_kind(value)
                    if kind:
                        self.module_locks[target.id] = LockDecl(
                            f"{self.short}.{target.id}", kind, self.path, stmt.lineno
                        )
                    ctor = self._ctor_type(value)
                    if ctor:
                        self.module_global_types[target.id] = ctor

    def _walk_defs(self, body: Sequence[ast.stmt], prefix: str, cls: Optional[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + stmt.name
                public = not stmt.name.startswith("_") or stmt.name in (
                    "__init__", "__enter__", "__exit__", "__call__", "__del__",
                )
                roles, locks = self._scan_annotations(stmt)
                self.functions[qual] = RaceFunc(
                    qualname=qual,
                    modname=self.modname,
                    path=self.path,
                    line=stmt.lineno,
                    cls=cls,
                    public=public,
                    declared_roles=roles,
                    declared_locks=locks,
                )
                self._walk_defs(stmt.body, prefix=qual + ".", cls=cls)
            elif isinstance(stmt, ast.ClassDef):
                self.class_locks.setdefault(stmt.name, {})
                self.class_attr_types.setdefault(stmt.name, {})
                self._walk_defs(stmt.body, prefix=prefix + stmt.name + ".", cls=stmt.name)
                self._scan_class_attrs(stmt)

    def _scan_annotations(self, node: ast.AST) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        roles: List[str] = []
        locks: List[str] = []
        for dec in getattr(node, "decorator_list", ()):
            if not isinstance(dec, ast.Call):
                continue
            name = dotted_name(dec.func)
            last = name.split(".")[-1] if name else ""
            bucket = roles if last == "thread_role" else locks if last == "locked_by" else None
            if bucket is None:
                continue
            for arg in dec.args:
                s = _const_str(arg)
                if s:
                    bucket.append(s)
        return tuple(roles), tuple(locks)

    def _scan_class_attrs(self, cls_node: ast.ClassDef) -> None:
        """``self.x = <ctor>()`` assignments anywhere in the class's methods."""
        locks = self.class_locks[cls_node.name]
        types = self.class_attr_types[cls_node.name]
        for node in ast.walk(cls_node):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for target in targets:
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                kind = self._lock_ctor_kind(value)
                if kind:
                    locks[target.attr] = LockDecl(
                        f"{cls_node.name}.{target.attr}", kind, self.path, node.lineno
                    )
                ctor = self._ctor_type(value)
                if ctor:
                    types[target.attr] = ctor

    def _scan_handler_install(self, node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            last = name.split(".")[-1]
            if last == "signal" and "." in name and len(node.args) == 2:
                sym = dotted_name(node.args[1])
                if sym and not sym.startswith("_PREV") and sym != "prev":
                    self.handler_installs.append(HandlerInstall("signal", sym, node.lineno))
            elif last == "register" and name.split(".")[0] in ("atexit",) and node.args:
                sym = dotted_name(node.args[0])
                self.handler_installs.append(HandlerInstall("atexit", sym, node.lineno))
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                tname = dotted_name(target)
                if tname and tname.endswith("excepthook"):
                    sym = dotted_name(node.value)
                    if sym and sym not in ("sys.__excepthook__",):
                        self.handler_installs.append(
                            HandlerInstall("excepthook", sym, node.lineno)
                        )

    # --------------------------------------------------- per-function walk

    def _lock_id_of(self, expr: ast.expr, func: RaceFunc, local_types: Dict[str, str]) -> Optional[Tuple[str, str]]:
        """Resolve an expression to ``(lock_id, kind)`` if lock-like."""
        if isinstance(expr, ast.Name):
            decl = self.module_locks.get(expr.id)
            if decl:
                return decl.lock_id, decl.kind
            ltype = local_types.get(expr.id)
            if ltype in _LOCK_CTORS:
                return f"{func.qualname}.<local {expr.id}>", ltype
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self" and func.cls:
                decl = self.class_locks.get(func.cls, {}).get(expr.attr)
                if decl:
                    return decl.lock_id, decl.kind
                return None
            # obj.lock where obj's type is a package class with that lock attr
            if isinstance(base, ast.Name):
                btype = local_types.get(base.id)
                if btype and expr.attr in self.class_locks.get(btype, {}):
                    decl = self.class_locks[btype][expr.attr]
                    return decl.lock_id, decl.kind
        return None

    def _target_id(self, node: ast.expr, func: RaceFunc) -> Optional[str]:
        """Shared-target identity for attribute/global writes (None = local)."""
        if isinstance(node, ast.Name):
            if node.id in self.module_globals:
                return f"{self.short}.{node.id}"
            return None
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self" and func.cls:
                return f"{func.cls}.{node.attr}"
            return None
        if isinstance(node, ast.Subscript):
            base = self._target_id(node.value, func)
            if base is None:
                return None
            key = _const_str(node.slice)
            return f"{base}[{key}]" if key is not None else base
        return None

    def _reads_target(self, value: ast.expr, target: str, func: RaceFunc) -> bool:
        for sub in ast.walk(value):
            if isinstance(sub, (ast.Name, ast.Attribute, ast.Subscript)):
                if self._target_id(sub, func) == target:
                    return True
        return False

    def _attr_type(self, recv: ast.expr, func: RaceFunc, local_types: Dict[str, str]) -> Optional[str]:
        if isinstance(recv, ast.Name):
            return local_types.get(recv.id) or self.module_global_types.get(recv.id)
        if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name):
            if recv.value.id == "self" and func.cls:
                return self.class_attr_types.get(func.cls, {}).get(recv.attr)
        return None

    def _analyze_function(self, func: RaceFunc) -> None:
        node = None
        # locate the def node again by position-independent qualname walk
        node = _find_def(self.tree, func.qualname)
        if node is None:
            return
        local_types: Dict[str, str] = {}
        # first pass: local constructor types (snap = _PendingSnapshot(...))
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Name):
                        ctor = self._ctor_type(sub.value)
                        if ctor:
                            local_types[tgt.id] = ctor
                        kind = self._lock_ctor_kind(sub.value)
                        if kind:
                            local_types[tgt.id] = kind
        self._walk_stmts(node.body, func, held=(), local_types=local_types)

    def _walk_stmts(
        self,
        body: Sequence[ast.stmt],
        func: RaceFunc,
        held: Tuple[str, ...],
        local_types: Dict[str, str],
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested defs are separate RaceFuncs
            if isinstance(stmt, ast.With):
                inner = held
                for item in stmt.items:
                    resolved = self._lock_id_of(item.context_expr, func, local_types)
                    if resolved:
                        lock_id, _kind = resolved
                        func.acquires.append(
                            Acquire(lock_id, stmt.lineno, stmt.col_offset, True, inner)
                        )
                        inner = inner + (lock_id,)
                    else:
                        self._scan_exprs([item.context_expr], func, held, local_types)
                self._walk_stmts(stmt.body, func, inner, local_types)
                continue
            self._scan_stmt(stmt, func, held, local_types)
            for sub_body in (
                getattr(stmt, "body", None),
                getattr(stmt, "orelse", None),
                getattr(stmt, "finalbody", None),
            ):
                if sub_body:
                    self._walk_stmts(sub_body, func, held, local_types)
            for handler in getattr(stmt, "handlers", ()) or ():
                self._walk_stmts(handler.body, func, held, local_types)

    def _scan_stmt(
        self, stmt: ast.stmt, func: RaceFunc, held: Tuple[str, ...], local_types: Dict[str, str]
    ) -> None:
        # ---- writes
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                tid = self._target_id(target, func)
                if tid is not None:
                    rmw = self._reads_target(stmt.value, tid, func)
                    func.mutations.append(
                        Mutation(
                            tid, stmt.lineno, stmt.col_offset,
                            "rmw" if rmw else "store", atomic=not rmw, held=held,
                        )
                    )
            self._scan_exprs([stmt.value], func, held, local_types)
            return
        if isinstance(stmt, ast.AugAssign):
            tid = self._target_id(stmt.target, func)
            if tid is not None:
                func.mutations.append(
                    Mutation(tid, stmt.lineno, stmt.col_offset, "augassign", False, held)
                )
            self._scan_exprs([stmt.value], func, held, local_types)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                tid = self._target_id(target, func)
                if tid is not None:
                    func.mutations.append(
                        Mutation(tid, stmt.lineno, stmt.col_offset, "delete", False, held)
                    )
            return
        # ---- everything else: scan contained expressions
        exprs = [v for v in ast.iter_child_nodes(stmt) if isinstance(v, ast.expr)]
        self._scan_exprs(exprs, func, held, local_types)

    def _scan_exprs(
        self,
        exprs: Sequence[ast.AST],
        func: RaceFunc,
        held: Tuple[str, ...],
        local_types: Dict[str, str],
    ) -> None:
        for root in exprs:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                self._scan_call(node, func, held, local_types)

    def _scan_call(
        self, call: ast.Call, func: RaceFunc, held: Tuple[str, ...], local_types: Dict[str, str]
    ) -> None:
        name = dotted_name(call.func) or ""
        last = name.split(".")[-1] if name else ""

        # -- thread spawn
        if last == "Thread" and (
            name.startswith("threading.")
            or self.imports.get(name, "").startswith("threading")
            or self.imports.get(name.split(".")[0], "").startswith("threading")
        ):
            func.spawns.append(self._spawn_site(call, func))
            return

        # -- explicit acquire: lock.acquire(...) — try-lock when blocking=False
        if isinstance(call.func, ast.Attribute) and call.func.attr == "acquire":
            resolved = self._lock_id_of(call.func.value, func, local_types)
            if resolved:
                lock_id, _kind = resolved
                blocking = True
                for kw in call.keywords:
                    if kw.arg == "blocking" and isinstance(kw.value, ast.Constant):
                        blocking = bool(kw.value.value)
                if call.args and isinstance(call.args[0], ast.Constant):
                    blocking = bool(call.args[0].value)
                func.acquires.append(
                    Acquire(lock_id, call.lineno, call.col_offset, blocking, held)
                )
                return

        # -- condition wait/notify on a held condition: releases, never blocks it
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("wait", "wait_for"):
            resolved = self._lock_id_of(call.func.value, func, local_types)
            if resolved and resolved[0] in held:
                return  # Condition.wait releases its own lock while waiting
            recv_t = self._attr_type(call.func.value, func, local_types)
            if recv_t == "Event":
                if held:
                    func.blocking_ops.append(
                        BlockingOp("event wait", name, call.lineno, call.col_offset, held)
                    )
                return

        # -- blocking host ops
        what = None
        if name in _BLOCKING_CALLS:
            what = _BLOCKING_CALLS[name]
        elif any(name.endswith("." + k) for k in _BLOCKING_CALLS):
            what = next(v for k, v in _BLOCKING_CALLS.items() if name.endswith("." + k))
        elif name in _BLOCKING_NAMES:
            what = _BLOCKING_NAMES[name]
        elif last in _BLOCKING_ATTRS:
            what = _BLOCKING_ATTRS[last]
        elif last in _ASARRAY_FUNCS and "." in name:
            base = name.split(".")[0]
            if self.imports.get(base, "").startswith("numpy") or base in ("np", "numpy"):
                what = "device->host transfer (np.asarray)"
        elif last == "join" and isinstance(call.func, ast.Attribute):
            recv = call.func.value
            recv_t = self._attr_type(recv, func, local_types)
            recv_name = dotted_name(recv) or ""
            if recv_t == "Thread" or recv_name.endswith("thread") or recv_name.endswith("_thread"):
                what = "thread join"
        if what is not None:
            func.blocking_ops.append(
                BlockingOp(what, name or last, call.lineno, call.col_offset, held)
            )
            # still record as a call (join/open aren't package calls; harmless)

        # -- container mutation through a method call
        if isinstance(call.func, ast.Attribute) and last in _MUTATING_METHODS:
            recv = call.func.value
            tid = self._target_id(recv, func)
            if tid is not None:
                recv_t = self._attr_type(recv, func, local_types) or ""
                atomic = (recv_t, last) in _ATOMIC_MUTCALLS
                # Event.set/clear are signals, not shared-container surgery
                if recv_t == "Event":
                    return
                # a known package class receiver is a method CALL, analyzed on
                # its own (Ring.append's internals carry the atomicity story)
                if recv_t and recv_t not in ("deque", "list", "dict", "set"):
                    func.calls.append(
                        CallSite(f"{recv_t}.{last}", recv_t, call.lineno, call.col_offset, held)
                    )
                    return
                func.mutations.append(
                    Mutation(tid, call.lineno, call.col_offset, f"mutcall:{last}", atomic, held)
                )
                return

        # -- ordinary call edge
        if name:
            recv_t = None
            if isinstance(call.func, ast.Attribute):
                recv_t = self._attr_type(call.func.value, func, local_types)
            func.calls.append(CallSite(name, recv_t, call.lineno, call.col_offset, held))

    def _spawn_site(self, call: ast.Call, func: RaceFunc) -> SpawnSite:
        target_sym: Optional[str] = None
        role: Optional[str] = None
        daemon = False
        for kw in call.keywords:
            if kw.arg == "target":
                target_sym = dotted_name(kw.value)
            elif kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                daemon = bool(kw.value.value)
            elif kw.arg == "name":
                role = _name_prefix(kw.value)
        if role is None:
            role = (target_sym or f"thread@{call.lineno}").replace("self.", "")
        joined = self._has_join_path(call, func)
        return SpawnSite(target_sym, role, daemon, joined, call.lineno, call.col_offset)

    def _has_join_path(self, call: ast.Call, func: RaceFunc) -> bool:
        """Whether the spawned handle is stored somewhere a ``.join`` reaches."""
        parent_assign: Optional[str] = None
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and node.value is call:
                tname = dotted_name(node.targets[0]) if node.targets else None
                if tname:
                    parent_assign = tname
        if parent_assign is None:
            return False
        scope = self.tree if parent_assign.startswith("self.") else _find_def(self.tree, func.qualname) or self.tree
        for node in ast.walk(scope):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
            ):
                recv = dotted_name(node.func.value)
                if recv == parent_assign:
                    return True
                # self._thread = Thread(...); later: thread = self._thread; thread.join()
                if parent_assign.startswith("self.") and recv == parent_assign.split(".", 1)[1]:
                    return True
        return False


def _find_def(tree: ast.AST, qualname: str):
    """Locate the (possibly nested) def node for a dotted qualname."""
    parts = qualname.split(".")
    scope: Sequence[ast.stmt] = tree.body  # type: ignore[attr-defined]
    node = None
    for part in parts:
        node = None
        for stmt in scope:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and stmt.name == part:
                node = stmt
                break
        if node is None:
            return None
        scope = node.body
    return node if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None


# -------------------------------------------------------------- package model


class RaceModel:
    """Phase B: linked package — roles, call graph, held-at-entry fixpoint."""

    def __init__(self, files: Dict[str, Tuple[str, str]]) -> None:
        self.modules: Dict[str, RaceModuleModel] = {}
        self.errors: Dict[str, str] = {}
        for path, (modname, source) in files.items():
            try:
                self.modules[path] = RaceModuleModel(path, modname, source)
            except SyntaxError as err:
                self.errors[path] = f"SyntaxError: {err}"
        self.by_modname = {m.modname: m for m in self.modules.values()}
        #: ClassName -> defining module (first wins; the repo has no dup classes)
        self.class_index: Dict[str, RaceModuleModel] = {}
        for m in self.modules.values():
            for cls in m.class_locks:
                self.class_index.setdefault(cls, m)
        #: all lock declarations by id
        self.locks: Dict[str, LockDecl] = {}
        for m in self.modules.values():
            for decl in m.module_locks.values():
                self.locks.setdefault(decl.lock_id, decl)
            for attrs in m.class_locks.values():
                for decl in attrs.values():
                    self.locks.setdefault(decl.lock_id, decl)
        self.link()

    # ------------------------------------------------------------- linking

    def all_functions(self):
        for m in self.modules.values():
            for func in m.functions.values():
                yield m, func

    def resolve_call(
        self, module: RaceModuleModel, site: CallSite, caller: RaceFunc
    ) -> Optional[Tuple[RaceModuleModel, RaceFunc]]:
        """Resolve one call site to a package function, or None (external)."""
        sym = site.symbol
        # receiver-typed method: Class.method
        if site.recv_type and site.recv_type in self.class_index:
            target_mod = self.class_index[site.recv_type]
            method = sym.split(".")[-1]
            hit = target_mod.functions.get(f"{site.recv_type}.{method}")
            if hit:
                return target_mod, hit
        if sym.startswith("self."):
            rest = sym[5:]
            if caller.cls:
                # self.method() or self.attr.method() via class attr types
                hit = module.functions.get(f"{caller.cls}.{rest}")
                if hit:
                    return module, hit
                if "." in rest:
                    attr, method = rest.split(".", 1)
                    atype = module.class_attr_types.get(caller.cls, {}).get(attr)
                    if atype and atype in self.class_index:
                        tmod = self.class_index[atype]
                        hit = tmod.functions.get(f"{atype}.{method.split('.')[-1]}")
                        if hit:
                            return tmod, hit
            return None
        if "." not in sym:
            # sibling nested function first (write() calling attempt_io())
            prefix = caller.qualname.rsplit(".", 1)[0] + "." if "." in caller.qualname else ""
            for cand in (prefix + sym, (caller.cls + "." + sym) if caller.cls else "", sym):
                if cand and cand in module.functions:
                    return module, module.functions[cand]
            imported = module.imports.get(sym)
            if imported and ":" in imported:
                modname, _, name = imported.partition(":")
                other = self.by_modname.get(modname)
                if other and name in other.functions:
                    return other, other.functions[name]
            return None
        base, _, attr = sym.partition(".")
        imported = module.imports.get(base)
        if imported:
            if ":" in imported:
                m, _, nm = imported.partition(":")
                sub = self.by_modname.get(f"{m}.{nm}")
                if sub and attr in sub.functions:
                    return sub, sub.functions[attr]
                # from pkg import mod as alias; alias.Class.method unlikely — skip
                return None
            other = self.by_modname.get(imported)
            if other:
                hit = other.functions.get(attr)
                if hit:
                    return other, hit
        # ClassName.method referenced directly
        if base in self.class_index:
            tmod = self.class_index[base]
            hit = tmod.functions.get(sym)
            if hit:
                return tmod, hit
        return None

    def _resolve_symbol(
        self, module: RaceModuleModel, sym: Optional[str], around: Optional[RaceFunc]
    ) -> Optional[Tuple[RaceModuleModel, RaceFunc]]:
        """Resolve a bare reference (spawn target / handler fn) to a function."""
        if not sym:
            return None
        fake = CallSite(sym, None, 0, 0, ())
        caller = around or RaceFunc("<module>", module.modname, module.path, 0, None, True)
        hit = self.resolve_call(module, fake, caller)
        if hit:
            return hit
        # nested-function suffix match (target=write inside save_checkpoint)
        tail = sym.split(".")[-1]
        for qual, func in module.functions.items():
            if qual == tail or qual.endswith("." + tail):
                return module, func
        return None

    def link(self) -> None:
        # ---- role seeds
        seeds: List[Tuple[RaceModuleModel, RaceFunc, str]] = []
        self.handler_entries: List[Tuple[RaceFunc, str]] = []
        self.spawned_entries: Set[str] = set()
        for m, func in self.all_functions():
            if func.public:
                seeds.append((m, func, "user"))
            for role in func.declared_roles:
                seeds.append((m, func, role))
                if any(role.startswith(k) or role == k for k in _HANDLER_KINDS):
                    self.handler_entries.append((func, role))
            for spawn in func.spawns:
                hit = self._resolve_symbol(m, spawn.target_symbol, func)
                if hit:
                    tmod, tfunc = hit
                    seeds.append((tmod, tfunc, spawn.role))
                    self.spawned_entries.add(tfunc.qualname)
        for m in self.modules.values():
            for install in m.handler_installs:
                hit = self._resolve_symbol(m, install.target_symbol, None)
                if hit:
                    tmod, tfunc = hit
                    seeds.append((tmod, tfunc, install.kind))
                    self.handler_entries.append((tfunc, install.kind))

        # ---- role propagation (BFS over call edges)
        work = list(seeds)
        while work:
            m, func, role = work.pop()
            if role in func.roles:
                continue
            func.roles.add(role)
            for site in func.calls:
                hit = self.resolve_call(m, site, func)
                if hit:
                    work.append((hit[0], hit[1], role))

        # ---- held-at-entry fixpoint (intersection over call sites)
        callers: Dict[str, List[Tuple[RaceFunc, CallSite]]] = {}
        key_of = lambda mm, ff: f"{mm.path}::{ff.qualname}"  # noqa: E731
        resolved_edges: Dict[str, List[str]] = {}
        funcs: Dict[str, Tuple[RaceModuleModel, RaceFunc]] = {}
        for m, func in self.all_functions():
            funcs[key_of(m, func)] = (m, func)
        for m, func in self.all_functions():
            for site in func.calls:
                hit = self.resolve_call(m, site, func)
                if hit:
                    k = key_of(hit[0], hit[1])
                    callers.setdefault(k, []).append((func, site))
                    resolved_edges.setdefault(key_of(m, func), []).append(k)
        for m, func in self.all_functions():
            if func.declared_locks:
                func.entry_held = frozenset(func.declared_locks)
            elif func.public or func.qualname in self.spawned_entries:
                func.entry_held = frozenset()
        for _ in range(len(funcs) + 2):
            changed = False
            for k, (m, func) in funcs.items():
                if func.declared_locks or func.public or func.qualname in self.spawned_entries:
                    continue
                sites = callers.get(k)
                if not sites:
                    if func.entry_held is None:
                        func.entry_held = frozenset()
                        changed = True
                    continue
                acc: Optional[frozenset] = None
                for caller, site in sites:
                    ce = caller.entry_held
                    if ce is None:
                        continue  # caller still top: skip (optimistic descent)
                    contrib = frozenset(site.held) | ce
                    acc = contrib if acc is None else (acc & contrib)
                if acc is not None and acc != func.entry_held:
                    func.entry_held = acc
                    changed = True
            if not changed:
                break
        for _, func in self.all_functions():
            if func.entry_held is None:
                func.entry_held = frozenset()

    # ------------------------------------------------- derived (rule inputs)

    def transitive_acquires(self, m: RaceModuleModel, func: RaceFunc, _seen=None) -> Set[str]:
        """Lock ids acquired by ``func`` or its package callees."""
        if _seen is None:
            _seen = set()
        k = f"{m.path}::{func.qualname}"
        if k in _seen:
            return set()
        _seen.add(k)
        out = {a.lock_id for a in func.acquires}
        for site in func.calls:
            hit = self.resolve_call(m, site, func)
            if hit:
                out |= self.transitive_acquires(hit[0], hit[1], _seen)
        return out

    def transitive_blocking(self, m: RaceModuleModel, func: RaceFunc, _seen=None) -> List[Tuple[RaceFunc, BlockingOp]]:
        """Blocking ops in ``func`` or its package callees (handler/lock sweeps)."""
        if _seen is None:
            _seen = set()
        k = f"{m.path}::{func.qualname}"
        if k in _seen:
            return []
        _seen.add(k)
        out = [(func, op) for op in func.blocking_ops]
        for site in func.calls:
            hit = self.resolve_call(m, site, func)
            if hit:
                out.extend(self.transitive_blocking(hit[0], hit[1], _seen))
        return out


def build_model(files: Dict[str, Tuple[str, str]]) -> RaceModel:
    """Build the linked thread-role model for ``load_package`` output."""
    return RaceModel(files)
