"""The buffer-ownership model: who owns which tensor, and which writes in place reach it.

Counterpart of ``metrics_tpu/analysis/own/buffer_model.py``, read for torch. JAX
donates a buffer into a compiled step (``donate_argnums``), which deletes it; the
port's counterpart is the CUDA-graph static buffer: a captured step
(``core/fused.py:CapturedStep``, built by ``compile_step``; run through a
``StepCache``) writes its new states IN PLACE into its static state buffers at every
replay, and the live state IS that buffer after a replay
(``core/fused.py:is_step_buffer``). An in-place accumulation (``add_``, ``copy_``,
``index_add_``, ``out=``) writes its receiver likewise.

Phase A parses every module of the analyzed tree into an
:class:`OwnModuleModel`: the function index (methods and nested defs), the
import table, and the class index — the same skeleton tmrace builds, but the
per-function pass here is a *provenance* dataflow instead of a lock walk.

Phase B (:class:`OwnModel`) links the package and runs an interprocedural
summary fixpoint: per-function summaries (``returns_owned``,
``returns_alias``, ``returns_donating``, snapshot/dedup shield) feed back into
every function's flow walk until stable, so ``compiled = self._compile(...)``
resolves to a donating step because ``_compile`` returns ``compile_step(...)``
two modules away.

The ownership lattice (per local name, flow-sensitive):

- ``OWNED``   — a fresh tensor of the program's own: the ``torch.zeros`` family,
  ``.clone()``, ``torch.tensor(...)`` (it copies), a copy across devices, torch
  compute, a step's outputs (``CapturedStep.__call__`` clones them).
- ``HOST``    — host-allocated numpy memory (``np.asarray``/``np.zeros``/...):
  ``torch.from_numpy``/``as_tensor`` over it shares it on the CPU.
- ``ALIAS``   — a tensor known to alias memory the program does not own:
  ``torch.from_numpy``, ``torch.as_tensor``/``asarray`` of host data,
  ``torch.frombuffer``, ``np.frombuffer`` payload views, ``memoryview``,
  ``.numpy()``, a ``.to()`` that may not copy, and views of any of these. Writing
  one in place (a replay's states, an in-place accumulation) is the PR 16 class
  (TMO-DONATE-ALIAS); ``x.clone() if x.data_ptr() == src.data_ptr() else x``
  (``ckpt/restore.py:_owned``) is the owning copy.
- ``UNKNOWN`` — anything else; never flagged (low-FP by construction).
- ``DONATED`` — passed as the states of a step's replay: the step's next replay
  overwrites it in place, so a read of the name after it, before re-pointing, is
  TMO-USE-AFTER-DONATE.

The walk emits :class:`OwnEvent` records; ``donation_rules.py`` turns them
into findings (separating facts from policy/phrasing, like tmrace's model /
rule-module split).
"""
import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.jitmap import dotted_name

# ------------------------------------------------------------------ lattice

OWNED = "owned"
HOST = "host"
ALIAS = "alias"
UNKNOWN = "unknown"
DONATED = "donated"

#: merge severity: the worst provenance wins at a control-flow join
_SEVERITY = {DONATED: 4, ALIAS: 3, HOST: 2, UNKNOWN: 1, OWNED: 0}

#: call last-components that materialize pending async-ckpt snapshots
_SNAPSHOT_SHIELDS = {
    "secure_pending_snapshots", "_secure_ckpt_snapshots", "_shield_donation",
}
#: call last-components that dedup duplicate buffers before donation
_DEDUP_SHIELDS = {"_donation_guard", "_shield_donation"}

#: numpy constructors that allocate (or wrap) host memory
_NP_HOST_CTORS = {
    "asarray", "array", "zeros", "ones", "empty", "full", "arange",
    "linspace", "copy", "ascontiguousarray", "stack", "concatenate",
}
#: numpy constructors that *wrap existing memory* without owning it
_NP_ALIAS_CTORS = {"frombuffer"}
#: torch calls whose result shares its host-data argument's memory
_TORCH_ALIAS_CTORS = {"from_numpy", "frombuffer"}
#: torch calls that share their argument's memory when they can (host data on the CPU)
_TORCH_MAYBE_ALIAS = {"as_tensor", "asarray"}
#: tensor methods that give a view of (or the same memory as) their receiver
_VIEW_METHODS = {
    "view", "view_as", "reshape", "reshape_as", "flatten", "squeeze", "unsqueeze", "expand", "expand_as",
    "narrow", "as_strided", "permute", "transpose", "t", "T", "detach", "contiguous", "unflatten", "select",
    "diagonal", "unbind", "split", "chunk", "movedim", "real", "imag", "numpy",
}
#: tensor methods that move a tensor, copying only when the target differs
_MOVE_METHODS = {"to", "cuda", "cpu", "type_as", "double", "float", "half", "bfloat16", "int", "long", "bool"}
#: the builders of a captured step: calling their result replays it, its states (position 0)
#: written in place
_STEP_BUILDERS = {"compile_step", "CapturedStep"}
#: in-place writes of their receiver (an accumulation on a state)
_INPLACE_METHODS = {
    "add_", "sub_", "mul_", "div_", "copy_", "index_add_", "index_copy_", "index_put_", "scatter_",
    "scatter_add_", "scatter_reduce_", "masked_fill_", "fill_", "zero_", "clamp_", "addcmul_", "addcdiv_",
    "lerp_", "put_", "maximum_", "minimum_",
}


def _merge_prov(*provs: str) -> str:
    return max(provs, key=lambda p: _SEVERITY.get(p, 1))


# ------------------------------------------------------------------ records


@dataclass
class OwnEvent:
    """One rule-relevant fact found by the flow walk (pre-finding)."""

    kind: str  # donate_alias | use_after_donate | double_donate | snapshot_gap | key_gap
    path: str
    line: int
    col: int
    symbol: str  # function qualname (key_gap: qualname.<missing name>)
    detail: str  # human fragment for the finding message


@dataclass
class OwnFunc:
    """Per-function facts: identity plus the Phase B analysis output."""

    qualname: str
    modname: str
    path: str
    line: int
    cls: Optional[str]
    params: Tuple[str, ...] = ()
    # filled per Phase B pass:
    events: List[OwnEvent] = field(default_factory=list)
    exec_sites: int = 0  # donating executions seen (engine_contract input)
    exec_lines: List[int] = field(default_factory=list)
    builds_donating: bool = False  # builds a captured step (compile_step/CapturedStep)
    cache_get: bool = False
    cache_store: bool = False
    demote_sentinel: bool = False  # references a *broken* key/sentinel
    warm_records: List[str] = field(default_factory=list)  # record_*_compile
    shield_calls: Set[str] = field(default_factory=set)  # snapshot | dedup
    key_exprs: List[str] = field(default_factory=list)  # unparse of cache keys
    key_fields: List[str] = field(default_factory=list)  # expanded key tuple
    # summary (interprocedural fixpoint state):
    returns_owned: bool = False
    returns_alias: bool = False
    returns_donating: Optional[Tuple[int, ...]] = None
    snapshot_shield: bool = False
    dedup_shield: bool = False

    def summary_key(self) -> Tuple:
        return (
            self.returns_owned, self.returns_alias, self.returns_donating,
            self.snapshot_shield, self.dedup_shield,
        )


# ------------------------------------------------------------- module model


class OwnModuleModel:
    """Phase A: one file's function index + import table."""

    def __init__(self, path: str, modname: str, source: str) -> None:
        self.path = path
        self.modname = modname
        self.short = modname.split(".")[-1]
        self.tree = ast.parse(source)
        self.imports: Dict[str, str] = {}
        self.functions: Dict[str, OwnFunc] = {}
        self.classes: Set[str] = set()
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    local = alias.asname or alias.name.split(".")[0]
                    self.imports[local] = alias.name
            elif isinstance(stmt, ast.ImportFrom) and stmt.module:
                for alias in stmt.names:
                    local = alias.asname or alias.name
                    self.imports[local] = f"{stmt.module}:{alias.name}"
        self._walk_defs(self.tree.body, prefix="", cls=None)

    def _walk_defs(self, body: Sequence[ast.stmt], prefix: str, cls: Optional[str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + stmt.name
                args = stmt.args
                params = tuple(
                    a.arg
                    for a in (args.posonlyargs + args.args + args.kwonlyargs)
                ) + tuple(a.arg for a in (args.vararg, args.kwarg) if a)
                self.functions[qual] = OwnFunc(
                    qualname=qual, modname=self.modname, path=self.path,
                    line=stmt.lineno, cls=cls, params=params,
                )
                self._walk_defs(stmt.body, prefix=qual + ".", cls=cls)
            elif isinstance(stmt, ast.ClassDef):
                self.classes.add(stmt.name)
                self._walk_defs(stmt.body, prefix=prefix + stmt.name + ".", cls=stmt.name)

    def find_def(self, qualname: str):
        """Locate the (possibly nested) def node for a dotted qualname."""
        parts = qualname.split(".")
        scope: Sequence[ast.stmt] = self.tree.body
        node = None
        for part in parts:
            node = None
            for stmt in scope:
                if (
                    isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and stmt.name == part
                ):
                    node = stmt
                    break
            if node is None:
                return None
            scope = node.body
        return node if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None

    # ---- numpy / torch recognition through the import table

    def _base_of(self, name: str) -> str:
        return name.split(".")[0]

    def is_numpy(self, name: str) -> bool:
        base = self._base_of(name)
        imported = self.imports.get(base, "")
        return base in ("np", "numpy") or imported.startswith("numpy")

    def is_torch(self, name: str) -> bool:
        base = self._base_of(name)
        imported = self.imports.get(base, "")
        return "." in name and (base == "torch" or imported == "torch" or imported.startswith("torch."))

    def is_torch_fresh(self, name: str) -> bool:
        """torch factories and compute (``torch.zeros``, ``torch.where``, ...): fresh tensors."""
        last = name.split(".")[-1]
        return self.is_torch(name) and last not in _TORCH_ALIAS_CTORS and last not in _TORCH_MAYBE_ALIAS


# ------------------------------------------------------------ package model


class OwnModel:
    """Phase B: linked package + summary fixpoint + flow walks."""

    def __init__(self, files: Dict[str, Tuple[str, str]]) -> None:
        self.modules: Dict[str, OwnModuleModel] = {}
        self.errors: Dict[str, str] = {}
        for path, (modname, source) in files.items():
            try:
                self.modules[path] = OwnModuleModel(path, modname, source)
            except SyntaxError as err:
                self.errors[path] = f"SyntaxError: {err}"
        self.by_modname = {m.modname: m for m in self.modules.values()}
        self.class_index: Dict[str, OwnModuleModel] = {}
        for m in self.modules.values():
            for cls in m.classes:
                self.class_index.setdefault(cls, m)
        self.link()

    def all_functions(self):
        for m in self.modules.values():
            for func in m.functions.values():
                yield m, func

    # ------------------------------------------------------------ resolver

    def resolve_call(
        self, module: OwnModuleModel, symbol: str, caller: OwnFunc
    ) -> Optional[Tuple[OwnModuleModel, OwnFunc]]:
        """Resolve a call symbol to a package function, or None (external)."""
        if symbol.startswith("self."):
            rest = symbol[5:]
            if caller.cls:
                hit = module.functions.get(f"{caller.cls}.{rest}")
                if hit:
                    return module, hit
            return None
        if "." not in symbol:
            prefix = caller.qualname.rsplit(".", 1)[0] + "." if "." in caller.qualname else ""
            for cand in (
                caller.qualname + "." + symbol,  # a def nested in the caller
                prefix + symbol,
                (caller.cls + "." + symbol) if caller.cls else "",
                symbol,
            ):
                if cand and cand in module.functions:
                    return module, module.functions[cand]
            imported = module.imports.get(symbol)
            if imported and ":" in imported:
                modname, _, name = imported.partition(":")
                other = self.by_modname.get(modname)
                if other and name in other.functions:
                    return other, other.functions[name]
            return None
        base, _, attr = symbol.partition(".")
        imported = module.imports.get(base)
        if imported:
            if ":" in imported:
                mn, _, nm = imported.partition(":")
                # from pkg import mod; mod.func(...)
                sub = self.by_modname.get(f"{mn}.{nm}")
                if sub and attr in sub.functions:
                    return sub, sub.functions[attr]
                # from pkg import Class; Class.method(...)
                if nm in self.class_index:
                    tmod = self.class_index[nm]
                    hit = tmod.functions.get(f"{nm}.{attr.split('.')[-1]}")
                    if hit:
                        return tmod, hit
                return None
            other = self.by_modname.get(imported)
            if other:
                hit = other.functions.get(attr)
                if hit:
                    return other, hit
        if base in self.class_index:
            tmod = self.class_index[base]
            hit = tmod.functions.get(symbol)
            if hit:
                return tmod, hit
        return None

    # ------------------------------------------------------------- linking

    def link(self) -> None:
        """Seed shield summaries by name, then run the summary fixpoint."""
        for _m, func in self.all_functions():
            last = func.qualname.split(".")[-1]
            if last in _SNAPSHOT_SHIELDS:
                func.snapshot_shield = True
            if last in _DEDUP_SHIELDS:
                func.dedup_shield = True
        # fixpoint: each pass re-walks every function body with the current
        # summaries; summaries only grow, so this converges in a few passes
        # (the repo's deepest donating chain is _launch -> _compile, depth 2).
        for _ in range(4):
            changed = False
            for m, func in self.all_functions():
                before = func.summary_key()
                _FlowWalker(self, m, func).run()
                if func.summary_key() != before:
                    changed = True
            if not changed:
                break


# ---------------------------------------------------------------- flow walk


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _handler_probes_deleted(handler: ast.ExceptHandler) -> bool:
    """True when the except body consults is_step_buffer/is_deleted/_leaf_deleted —
    the sanctioned recovery idiom (the runtime twin of TMO-USE-AFTER-DONATE)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Attribute) and node.attr in ("is_deleted", "is_step_buffer"):
            return True
        if isinstance(node, ast.Name) and node.id == "is_step_buffer":
            return True
        if isinstance(node, ast.Constant) and node.value == "is_deleted":
            return True
        if isinstance(node, ast.Name) and "_leaf_deleted" in node.id:
            return True
    return False


class _FlowWalker:
    """One function's provenance walk: fills func.events and the summary."""

    def __init__(self, model: OwnModel, module: OwnModuleModel, func: OwnFunc) -> None:
        self.model = model
        self.module = module
        self.func = func
        self.node = module.find_def(func.qualname)
        self.events: List[OwnEvent] = []
        self.snapshot_seen = False
        self.dedup_seen = False
        self.exempt_uad = 0  # inside an is_deleted-probing except handler
        self.uad_reported: Set[str] = set()
        self.exec_sites = 0
        self.exec_lines: List[int] = []
        self.exec_calls: List[ast.Call] = []
        self.steps_calls: Set[int] = set()  # the execs that are a StepCache's call
        #: names bound together by one tuple unpack (``key, states, ... = build(...)``)
        self.unpacked: List[Set[str]] = []
        self.builds_donating = False
        self.cache_get = False
        self.cache_store = False
        self.demote_sentinel = False
        self.warm_records: List[str] = []
        self.shield_calls: Set[str] = set()
        self.cache_key_nodes: List[ast.AST] = []
        self.donating_call_args: List[ast.Call] = []  # calls returning donating
        self.jit_targets: List[ast.AST] = []  # first arg of compile_step/CapturedStep(...)
        self.ret_provs: List[str] = []
        self.ret_donating: Optional[Tuple[int, ...]] = None
        # flow-insensitive prepasses
        self.assigns: Dict[str, List[ast.expr]] = {}
        self.nested_defs: Dict[str, ast.AST] = {}
        self.donating_names: Dict[str, Tuple[int, ...]] = {}
        if self.node is not None:
            self._prepass()

    # ------------------------------------------------------------ prepass

    def _prepass(self) -> None:
        for node in ast.walk(self.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    self.assigns.setdefault(tgt.id, []).append(node.value)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    self.unpacked.append({e.id for e in tgt.elts if isinstance(e, ast.Name)})
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not self.node:
                    self.nested_defs.setdefault(node.name, node)
            if isinstance(node, (ast.Name, ast.Attribute)):
                dn = dotted_name(node) or ""
                if "broken" in dn.lower().split(".")[-1].lower():
                    self.demote_sentinel = True
        # donating-wrapper fixpoint over local assignments (cache.get can
        # lexically precede the compile assignment that types the name)
        for _ in range(4):
            changed = False
            for name, values in self.assigns.items():
                if name in self.donating_names:
                    continue
                for value in values:
                    pos = self._donating_of(value)
                    if pos:
                        self.donating_names[name] = pos
                        changed = True
                        break
            if not changed:
                break

    def _donating_of(self, expr: ast.AST) -> Optional[Tuple[int, ...]]:
        """Donate positions when ``expr`` evaluates to a donating wrapper or
        step (compile_step/CapturedStep, or a call whose summary returns one)."""
        if isinstance(expr, ast.Name):
            return self.donating_names.get(expr.id)
        if not isinstance(expr, ast.Call):
            return None
        fn = expr.func
        name = dotted_name(fn) or ""
        last = name.split(".")[-1]
        if last in _STEP_BUILDERS:
            # the step's replay writes its states (argument 0) into the static buffers
            if expr.args:
                self.jit_targets.append(expr.args[0])
            self.builds_donating = True
            return (0,)
        # interprocedural: a call whose resolved summary returns an executable
        if name:
            hit = self.model.resolve_call(self.module, name, self.func)
            if hit and hit[1].returns_donating:
                self.donating_call_args.append(expr)
                return hit[1].returns_donating
        return None

    # ---------------------------------------------------------------- run

    def run(self) -> None:
        if self.node is None:
            return
        env: Dict[str, str] = {}
        self._flow(self.node.body, env)
        # summary
        f = self.func
        f.events = self.events + self._key_gap_events()
        f.exec_sites = self.exec_sites
        f.exec_lines = self.exec_lines
        f.builds_donating = f.builds_donating or self.builds_donating
        f.cache_get = self.cache_get
        f.cache_store = self.cache_store
        f.demote_sentinel = self.demote_sentinel
        f.warm_records = self.warm_records
        f.shield_calls = self.shield_calls
        f.key_exprs = [
            _safe_unparse(n) for n in self.cache_key_nodes
        ]
        f.key_fields = self._key_fields()
        if self.ret_provs:
            f.returns_owned = all(p == OWNED for p in self.ret_provs)
            f.returns_alias = f.returns_alias or any(p == ALIAS for p in self.ret_provs)
        if self.ret_donating:
            f.returns_donating = self.ret_donating
        # shield-ness propagates to callers only through dedicated helpers:
        # a function with its own donating execs consumes, not provides, it
        if self.exec_sites == 0:
            if "snapshot" in self.shield_calls:
                f.snapshot_shield = True
            if "dedup" in self.shield_calls:
                f.dedup_shield = True

    # ------------------------------------------------------ statement walk

    def _flow(self, body: Sequence[ast.stmt], env: Dict[str, str]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # separate OwnFuncs
            if isinstance(stmt, ast.Assign):
                prov = self._scan_expr(stmt.value, env)
                for target in stmt.targets:
                    if isinstance(target, ast.Subscript):
                        recv = dotted_name(target.value) or ""
                        if "cache" in recv.lower():
                            self.cache_store = True
                            self.cache_key_nodes.append(target.slice)
                    self._assign_target(target, prov, env)
            elif isinstance(stmt, ast.AnnAssign):
                if stmt.value is not None:
                    prov = self._scan_expr(stmt.value, env)
                    self._assign_target(stmt.target, prov, env)
            elif isinstance(stmt, ast.AugAssign):
                self._scan_expr(stmt.value, env)
                if isinstance(stmt.target, ast.Name):
                    env[stmt.target.id] = UNKNOWN
            elif isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    pos = self._donating_of(stmt.value)
                    if pos:
                        self.ret_donating = pos
                    self.ret_provs.append(self._scan_expr(stmt.value, env))
                else:
                    self.ret_provs.append(UNKNOWN)
            elif isinstance(stmt, ast.If):
                self._scan_expr(stmt.test, env)
                self._branch([stmt.body, stmt.orelse], env)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter, env)
                if isinstance(stmt.target, ast.Name):
                    env[stmt.target.id] = UNKNOWN
                self._branch([stmt.body, stmt.orelse], env)
            elif isinstance(stmt, ast.While):
                self._scan_expr(stmt.test, env)
                self._branch([stmt.body, stmt.orelse], env)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._scan_expr(item.context_expr, env)
                    if item.optional_vars is not None and isinstance(item.optional_vars, ast.Name):
                        env[item.optional_vars.id] = UNKNOWN
                self._flow(stmt.body, env)
            elif isinstance(stmt, ast.Try):
                self._flow(stmt.body, env)
                for handler in stmt.handlers:
                    henv = dict(env)
                    exempt = _handler_probes_deleted(handler)
                    if exempt:
                        self.exempt_uad += 1
                    try:
                        self._flow(handler.body, henv)
                    finally:
                        if exempt:
                            self.exempt_uad -= 1
                self._flow(stmt.orelse, env)
                self._flow(stmt.finalbody, env)
            elif isinstance(stmt, (ast.Expr, ast.Raise, ast.Assert, ast.Delete)):
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.expr):
                        self._scan_expr(child, env)
            else:
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.expr):
                        self._scan_expr(child, env)

    def _branch(self, bodies: Sequence[Sequence[ast.stmt]], env: Dict[str, str]) -> None:
        """Walk alternative bodies on copies and merge worst-case back."""
        shield0 = (self.snapshot_seen, self.dedup_seen)
        branch_envs: List[Dict[str, str]] = []
        shields: List[Tuple[bool, bool]] = []
        for body in bodies:
            benv = dict(env)
            self.snapshot_seen, self.dedup_seen = shield0
            self._flow(body, benv)
            branch_envs.append(benv)
            shields.append((self.snapshot_seen, self.dedup_seen))
        # a shield only dominates later code if every path passed it
        self.snapshot_seen = all(s for s, _ in shields)
        self.dedup_seen = all(d for _, d in shields)
        keys = set(env)
        for benv in branch_envs:
            keys |= set(benv)
        for k in keys:
            vals = [benv.get(k, env.get(k, UNKNOWN)) for benv in branch_envs]
            env[k] = _merge_prov(*vals)

    def _assign_target(self, target: ast.AST, prov: str, env: Dict[str, str]) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = prov
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                # an exec result unpack re-points every target at fresh buffers
                self._assign_target(elt, prov if prov == OWNED else UNKNOWN, env)
        # attribute/subscript stores don't change local provenance

    # ----------------------------------------------------- expression walk

    def _scan_expr(self, expr: ast.AST, env: Dict[str, str]) -> str:
        """Scan for rule events; return the expression's provenance."""
        if isinstance(expr, ast.Name):
            prov = env.get(expr.id, UNKNOWN)
            if prov == DONATED and not self.exempt_uad and expr.id not in self.uad_reported:
                self.uad_reported.add(expr.id)
                self.events.append(
                    OwnEvent(
                        "use_after_donate", self.func.path, expr.lineno,
                        expr.col_offset, self.func.qualname,
                        f"`{expr.id}` was donated and is dead here",
                    )
                )
            return prov
        if isinstance(expr, ast.Call):
            return self._scan_call(expr, env)
        if isinstance(expr, ast.Attribute):
            # the sanctioned liveness probe reads a maybe-dead buffer on purpose
            if expr.attr in ("is_deleted", "is_step_buffer"):
                return UNKNOWN
            base = self._scan_expr(expr.value, env)
            return ALIAS if base == ALIAS else UNKNOWN
        if isinstance(expr, ast.Subscript):
            base = self._scan_expr(expr.value, env)
            self._scan_expr(expr.slice, env)
            return ALIAS if base == ALIAS else UNKNOWN
        if isinstance(expr, ast.Starred):
            return self._scan_expr(expr.value, env)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            provs = [self._scan_expr(e, env) for e in expr.elts]
            return _merge_prov(UNKNOWN, *provs) if provs else UNKNOWN
        if isinstance(expr, ast.Dict):
            provs = [self._scan_expr(v, env) for v in expr.values if v is not None]
            for k in expr.keys:
                if k is not None:
                    self._scan_expr(k, env)
            return _merge_prov(UNKNOWN, *provs) if provs else UNKNOWN
        if isinstance(expr, ast.IfExp):
            self._scan_expr(expr.test, env)
            body, orelse = self._scan_expr(expr.body, env), self._scan_expr(expr.orelse, env)
            if _clone_if_aliased(expr):
                return OWNED  # ``x.clone() if x.data_ptr() == src.data_ptr() else x``: x owns its memory
            return _merge_prov(body, orelse)
        if isinstance(expr, (ast.Lambda,)):
            return UNKNOWN  # opaque; nested defs are separate functions
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            cenv = dict(env)
            for gen in expr.generators:
                self._scan_expr(gen.iter, cenv)
                if isinstance(gen.target, ast.Name):
                    cenv[gen.target.id] = UNKNOWN
                elif isinstance(gen.target, (ast.Tuple, ast.List)):
                    for elt in gen.target.elts:
                        if isinstance(elt, ast.Name):
                            cenv[elt.id] = UNKNOWN
                for cond in gen.ifs:
                    self._scan_expr(cond, cenv)
            for part in ("elt", "key", "value"):
                sub = getattr(expr, part, None)
                if sub is not None:
                    self._scan_expr(sub, cenv)
            return UNKNOWN
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._scan_expr(child, env)
        return UNKNOWN

    def _scan_call(self, call: ast.Call, env: Dict[str, str]) -> str:
        name = dotted_name(call.func) or ""
        last = name.split(".")[-1]

        # ---- shields (statement-order domination for later donating execs)
        is_shield = False
        if last in _SNAPSHOT_SHIELDS:
            self.snapshot_seen = True
            self.shield_calls.add("snapshot")
            is_shield = True
        if last in _DEDUP_SHIELDS:
            self.dedup_seen = True
            self.shield_calls.add("dedup")
            is_shield = True
        if not is_shield and name:
            hit = self.model.resolve_call(self.module, name, self.func)
            if hit:
                if hit[1].snapshot_shield:
                    self.snapshot_seen = True
                    self.shield_calls.add("snapshot")
                    is_shield = True
                if hit[1].dedup_shield:
                    self.dedup_seen = True
                    self.shield_calls.add("dedup")
                    is_shield = True

        # ---- warm-manifest record hook (engine_contract input)
        if last.startswith("record_") and last.endswith("_compile"):
            self.warm_records.append(last)

        # ---- step-cache traffic: ``cache.get(key)``, and a ``StepCache``'s
        # ``steps.call(key, make_step, states, extras, ...)``, which runs the key's step
        steps_call = False
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("get", "call", "insert") and call.args:
            recv = (dotted_name(call.func.value) or "").lower()
            tail = recv.split(".")[-1]
            if ("cache" in recv and call.func.attr == "get") or (
                    call.func.attr in ("call", "insert") and ("steps" in tail or "cache" in tail)):
                self.cache_get = True
                self.cache_key_nodes.append(call.args[0])
                steps_call = call.func.attr == "call" and len(call.args) > 2

        # ---- donating execution? (a replay of a captured step, or a step cache's call)
        positions = (2,) if steps_call else self._donating_of_callable(call.func)
        if isinstance(call.func, ast.Attribute) and call.func.attr in _INPLACE_METHODS:
            self._record_inplace(call, self._scan_expr(call.func.value, env))
        arg_provs = [self._scan_expr(a, env) for a in call.args]
        for kw in call.keywords:
            prov = self._scan_expr(kw.value, env)
            if kw.arg == "out" and self.module.is_torch(name):
                self._record_inplace(call, prov, kw.value)

        if positions:
            if steps_call:
                self.steps_calls.add(id(call))
            self._record_exec(call, positions, arg_provs, env)
            return OWNED  # a replay's outputs are clones, its states re-pointed by the caller

        # ---- provenance of ordinary calls
        return self._call_prov(call, name, last, arg_provs, env)

    def _record_inplace(self, call: ast.Call, prov: str, target: Optional[ast.AST] = None) -> None:
        """TMO-DONATE-ALIAS of an in-place write: its receiver (or ``out=``) aliases host memory."""
        node = target if target is not None else call.func.value
        if prov in (ALIAS, HOST):
            what = ("aliases host memory (torch.from_numpy/frombuffer/as_tensor of host data)" if prov == ALIAS
                    else "is host-allocated numpy memory")
            self.events.append(
                OwnEvent(
                    "donate_alias", self.func.path, node.lineno, node.col_offset, self.func.qualname,
                    f"tensor written in place (`{_safe_unparse(node)}`) {what}",
                )
            )

    def _donating_of_callable(self, fn: ast.AST) -> Optional[Tuple[int, ...]]:
        if isinstance(fn, ast.Name):
            return self.donating_names.get(fn.id)
        if isinstance(fn, ast.Call):
            return self._donating_of(fn)
        return None

    def _record_exec(
        self,
        call: ast.Call,
        positions: Tuple[int, ...],
        arg_provs: List[str],
        env: Dict[str, str],
    ) -> None:
        self.exec_sites += 1
        self.exec_lines.append(call.lineno)
        self.exec_calls.append(call)
        donated_exprs: List[Tuple[int, ast.AST, str]] = []
        for pos in positions:
            # a Starred at or before the position makes the mapping ambiguous;
            # one after it (compiled(state, *extras)) does not shift it
            if pos < len(call.args) and not any(
                isinstance(a, ast.Starred) for a in call.args[: pos + 1]
            ):
                arg = call.args[pos]
                if isinstance(arg, (ast.List, ast.Tuple)):
                    # a states tree written out: each leaf is an in-place position of its own
                    for i, elt in enumerate(arg.elts):
                        donated_exprs.append((pos + i, elt, self._scan_expr(elt, env)))
                else:
                    donated_exprs.append((pos, arg, arg_provs[pos]))
        # TMO-DONATE-ALIAS
        for pos, arg, prov in donated_exprs:
            if prov in (ALIAS, HOST):
                what = (
                    "aliases host memory (np.frombuffer/memoryview/torch.from_numpy/as_tensor of host data)"
                    if prov == ALIAS
                    else "is host-allocated numpy memory (shared with a CPU tensor)"
                )
                self.events.append(
                    OwnEvent(
                        "donate_alias", self.func.path, arg.lineno, arg.col_offset,
                        self.func.qualname,
                        f"state {pos} of a replay (`{_safe_unparse(arg)}`) {what}",
                    )
                )
        # TMO-DOUBLE-DONATE
        if len(donated_exprs) > 1 and not self.dedup_seen:
            seen_text: Dict[str, int] = {}
            for pos, arg, _prov in donated_exprs:
                text = _safe_unparse(arg)
                if text in seen_text:
                    self.events.append(
                        OwnEvent(
                            "double_donate", self.func.path, call.lineno,
                            call.col_offset, self.func.qualname,
                            f"`{text}` reaches donated positions {seen_text[text]} "
                            f"and {pos} of one call with no dedup guard",
                        )
                    )
                else:
                    seen_text[text] = pos
        # TMO-SNAPSHOT-GAP: the donated value must be shield-processed, either
        # by a dominating shield call or because it came out of one
        # (fleet: state = _shield_donation(metric, state)).
        if not self.snapshot_seen:
            shielded_args = all(
                self._from_shield(arg, env) for _pos, arg, _prov in donated_exprs
            ) and bool(donated_exprs)
            if not shielded_args:
                self.events.append(
                    OwnEvent(
                        "snapshot_gap", self.func.path, call.lineno, call.col_offset,
                        self.func.qualname,
                        "replay not dominated by secure_pending_snapshots "
                        "(an async checkpoint may reference the states it overwrites)",
                    )
                )
        # mark donated names dead
        for _pos, arg, _prov in donated_exprs:
            if isinstance(arg, ast.Name):
                env[arg.id] = DONATED

    def _from_shield(self, arg: ast.AST, env: Dict[str, str]) -> bool:
        """Whether a donated arg was produced by a shield call (assignment)."""
        if not isinstance(arg, ast.Name):
            return False
        for value in self.assigns.get(arg.id, ()):
            if isinstance(value, ast.Call):
                vlast = (dotted_name(value.func) or "").split(".")[-1]
                if vlast in _SNAPSHOT_SHIELDS:
                    return True
        return False

    def _call_prov(
        self, call: ast.Call, name: str, last: str, arg_provs: List[str], env: Dict[str, str]
    ) -> str:
        arg0 = _merge_prov(UNKNOWN, *arg_provs) if arg_provs else UNKNOWN
        if last == "memoryview":
            return ALIAS
        if self.module.is_numpy(name):
            if last in _NP_ALIAS_CTORS:
                return ALIAS
            if last in _NP_HOST_CTORS:
                return ALIAS if arg0 == ALIAS else HOST
            return HOST
        if self.module.is_torch(name):
            if last in _TORCH_ALIAS_CTORS:
                return ALIAS
            if last in _TORCH_MAYBE_ALIAS:
                # shares host data's memory on the CPU; a tensor comes back as it is
                return ALIAS if arg0 in (HOST, ALIAS) else (OWNED if arg0 == OWNED else UNKNOWN)
            return OWNED  # torch factories and compute; torch.tensor copies
        if isinstance(call.func, ast.Attribute):
            method = call.func.attr
            base = self._scan_expr(call.func.value, dict(env)) if method in _VIEW_METHODS | _MOVE_METHODS else None
            if method in ("clone", "copy"):
                return OWNED
            if method in _VIEW_METHODS:
                return ALIAS if base in (ALIAS, HOST) else (OWNED if base == OWNED and method != "numpy" else UNKNOWN)
            if method in _MOVE_METHODS:
                # a .to() that does not copy (already there) keeps the alias
                return ALIAS if base in (ALIAS, HOST) else (OWNED if base == OWNED else UNKNOWN)
        if name:
            hit = self.model.resolve_call(self.module, name, self.func)
            if hit:
                if hit[1].returns_alias:
                    return ALIAS
                if hit[1].returns_owned:
                    return OWNED
        return UNKNOWN

    def _key_fields(self) -> List[str]:
        """The cache-key tuple's components, with one level of local-name
        expansion (``sig := ('scan', ...) | tuple(...)``) — the worksheet's
        per-engine key inventory. A key built by a package function (``key =
        key_of(...)``, or unpacked from a builder's returned tuple) is read in
        that function."""
        for node in self.cache_key_nodes:
            fields = _tuple_fields(node, self.assigns)
            if fields is None and isinstance(node, ast.Name):
                fields = self._key_fields_in_builder(node.id)
            if fields is not None:
                return fields
        return []

    def _key_fields_in_builder(self, name: str) -> Optional[List[str]]:
        """The fields of a key ``name`` that a resolvable package function returns."""
        sources: List[Tuple[ast.Call, Optional[int]]] = [
            (v, None) for v in self.assigns.get(name, ()) if isinstance(v, ast.Call)]
        for node in ast.walk(self.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                    node.targets[0], (ast.Tuple, ast.List)) and isinstance(node.value, ast.Call):
                names = [e.id if isinstance(e, ast.Name) else None for e in node.targets[0].elts]
                if name in names:
                    sources.append((node.value, names.index(name)))
        for value, assigns in self._builder_keys(name):
            fields = _tuple_fields(value, assigns)
            if fields is not None:
                return fields
        return None

    def _builder_keys(self, name: str) -> List[Tuple[ast.AST, Dict[str, List[ast.expr]]]]:
        """``(key expression, assignments in scope)`` of each package function whose result
        is the key ``name`` (``key = key_of(...)``, or unpacked from a builder's returned
        tuple); the assignments are the function's and its enclosing functions'."""
        sources: List[Tuple[ast.Call, Optional[int]]] = [
            (v, None) for v in self.assigns.get(name, ()) if isinstance(v, ast.Call)]
        for node in ast.walk(self.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                    node.targets[0], (ast.Tuple, ast.List)) and isinstance(node.value, ast.Call):
                names = [e.id if isinstance(e, ast.Name) else None for e in node.targets[0].elts]
                if name in names:
                    sources.append((node.value, names.index(name)))
        out: List[Tuple[ast.AST, Dict[str, List[ast.expr]]]] = []
        for call, index in sources:
            hit = self.model.resolve_call(self.module, dotted_name(call.func) or "", self.func)
            node = hit[0].find_def(hit[1].qualname) if hit else None
            if node is None:
                continue
            assigns: Dict[str, List[ast.expr]] = {}
            parts = hit[1].qualname.split(".")
            for depth in range(1, len(parts) + 1):  # the function and the defs it is nested in
                scope = hit[0].find_def(".".join(parts[:depth]))
                for sub in ast.walk(scope) if scope is not None else ():
                    if isinstance(sub, (ast.Assign, ast.AnnAssign)) and sub.value is not None:
                        targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                        if len(targets) == 1 and isinstance(targets[0], ast.Name):
                            assigns.setdefault(targets[0].id, []).append(sub.value)
            for ret in (r for r in ast.walk(node) if isinstance(r, ast.Return) and r.value is not None):
                value = ret.value
                if index is not None:
                    if not isinstance(value, ast.Tuple) or index >= len(value.elts):
                        continue
                    value = value.elts[index]
                out.append((value, assigns))
        return out

    # ------------------------------------------------------------- key gap

    def _key_gap_events(self) -> List[OwnEvent]:
        """TMO-KEY-GAP: the step-cache key must cover everything the captured step was
        specialized on — the shapes of its runtime arguments, donating-call args,
        builder args, and the closed-over locals of a locally-defined step."""
        if not self.exec_calls or not self.cache_key_nodes:
            return []
        feed: Set[str] = set()
        for key in self.cache_key_nodes:
            feed |= _names_in(key)
            if isinstance(key, ast.Name):
                # a key a package function builds: the names its key expression reads there
                for value, assigns in self._builder_keys(key.id):
                    names = _names_in(value)
                    for _ in range(len(assigns) + 1):
                        more = set().union(*(_names_in(v) for n in names for v in assigns.get(n, ())))
                        if more <= names:
                            break
                        names |= more
                    feed |= names
        # transitive closure through local assignments (sig <- dyn_lists, ...), and
        # through the names one call built together with a key name
        for _ in range(len(self.assigns) + len(self.unpacked) + 1):
            grew = False
            for name in list(feed):
                for value in self.assigns.get(name, ()):
                    new = _names_in(value)
                    if not new <= feed:
                        feed |= new
                        grew = True
                for group in self.unpacked:
                    if name in group and not group <= feed:
                        feed |= group
                        grew = True
            if not grew:
                break
        events: List[OwnEvent] = []
        reported: Set[str] = set()

        def missing(name: str, node: ast.AST, what: str) -> None:
            if name in feed or name in reported:
                return
            reported.add(name)
            events.append(
                OwnEvent(
                    "key_gap", self.func.path, node.lineno, node.col_offset,
                    f"{self.func.qualname}.{name}",
                    f"`{name}` ({what}) is not covered by the step-cache key",
                )
            )

        for call in self.exec_calls:
            # a StepCache's call(key, make_step, states, extras, ...): the runtime arguments
            runtime = call.args[2:4] if id(call) in self.steps_calls else call.args
            for arg in runtime:
                for leaf in (arg.elts if isinstance(arg, (ast.List, ast.Tuple)) else [arg]):
                    if isinstance(leaf, ast.Name):
                        missing(leaf.id, leaf, "runtime argument of the captured step (its shape and dtype)")
                    elif isinstance(leaf, ast.Starred) and isinstance(leaf.value, ast.Name):
                        missing(leaf.value.id, leaf, "runtime argument of the captured step (its shape and dtype)")
        for call in self.donating_call_args:
            for arg in call.args:
                if isinstance(arg, ast.Name):
                    missing(arg.id, arg, "input of the step-producing call")
        for target in self.jit_targets:
            if not isinstance(target, ast.Name):
                continue
            # step = self._build_xxx(a, b, c): builder args specialize the trace
            for value in self.assigns.get(target.id, ()):
                if isinstance(value, ast.Call):
                    for arg in value.args:
                        if isinstance(arg, ast.Name):
                            missing(arg.id, arg, f"argument of the `{target.id}` builder")
            # def step(...) closing over outer locals/params
            nested = self.nested_defs.get(target.id)
            if nested is not None:
                self._check_closure(nested, feed, missing)
        return events

    def _check_closure(self, nested: ast.AST, feed: Set[str], missing) -> None:
        args = nested.args
        inner_bound = {
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)
        } | {a.arg for a in (args.vararg, args.kwarg) if a}
        for node in ast.walk(nested):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        inner_bound.add(t.id)
        outer_names = set(self.func.params) | set(self.assigns)
        for node in ast.walk(nested):
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id not in inner_bound
                and node.id in outer_names
            ):
                missing(node.id, node, "closed over by the traced step")


def _tuple_fields(node: ast.AST, assigns: Dict[str, List[ast.expr]]) -> Optional[List[str]]:
    """The components of a key tuple (``node`` or the tuple a local name was assigned),
    each local name expanded one level; None when it is no tuple."""
    tup = node
    if isinstance(node, ast.Name):
        tup = next((v for v in assigns.get(node.id, ()) if isinstance(v, ast.Tuple)), node)
    if not isinstance(tup, ast.Tuple):
        return None
    fields: List[str] = []
    for elt in tup.elts:
        if isinstance(elt, ast.Name) and elt.id in assigns:
            fields.append(f"{elt.id} := {' | '.join(sorted({_safe_unparse(v) for v in assigns[elt.id]}))}")
        else:
            fields.append(_safe_unparse(elt))
    return fields


def _clone_if_aliased(expr: ast.IfExp) -> bool:
    """``a.clone() if <data_ptr test> else a`` (or the branches swapped): the owning-copy
    idiom of ``ckpt/restore.py:_owned``, where ``a`` came out of a ``.to()``."""
    tests_ptr = any(isinstance(n, ast.Attribute) and n.attr == "data_ptr" for n in ast.walk(expr.test))
    clones = [b for b in (expr.body, expr.orelse)
              if isinstance(b, ast.Call) and isinstance(b.func, ast.Attribute) and b.func.attr == "clone"]
    return tests_ptr and len(clones) == 1


def _safe_unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — display only
        return "<expr>"


def build_model(files: Dict[str, Tuple[str, str]]) -> OwnModel:
    """Build the linked ownership model for ``load_package`` output."""
    return OwnModel(files)
