"""Lock-discipline rules: TMR-UNLOCKED, TMR-HOLD-HOST, TMR-LEAK.

All three read the linked :class:`~metrics_tpu_torch.analysis.race.thread_model
.RaceModel`; the held set at any site is ``local_held ∪ entry_held`` — the
with-stack at the statement plus the interprocedural caller-holds contract
(inferred intersection over call sites, or the explicit ``@locked_by``).
"""
from typing import Dict, List, Tuple

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.race.thread_model import (
    BlockingOp,
    Mutation,
    RaceFunc,
    RaceModel,
    RaceModuleModel,
)


def _full_held(func: RaceFunc, local: Tuple[str, ...]) -> frozenset:
    return frozenset(local) | (func.entry_held or frozenset())


def _sym(func: RaceFunc) -> str:
    """Finding symbol: ``Class.method`` / ``func`` (nested defs keep the chain)."""
    return func.qualname


# ------------------------------------------------------------- TMR-UNLOCKED


def unlocked_findings(model: RaceModel) -> List[Finding]:
    """Shared target mutated (non-atomically) from >=2 roles with >=1 write
    outside every candidate governing lock."""
    # target -> [(module, func, mutation)]
    sites: Dict[str, List[Tuple[RaceModuleModel, RaceFunc, Mutation]]] = {}
    for m, func in model.all_functions():
        for mut in func.mutations:
            if mut.atomic:
                continue
            sites.setdefault(mut.target, []).append((m, func, mut))
    out: List[Finding] = []
    for target, entries in sorted(sites.items()):
        roles = set()
        for _m, func, _mut in entries:
            roles |= func.roles
        if len(roles) < 2:
            continue  # single-role targets cannot race
        helds = [_full_held(func, mut.held) for _m, func, mut in entries]
        governing = frozenset.intersection(*helds) if helds else frozenset()
        if governing:
            continue  # one lock covers every write
        # anchor at the least-protected write
        m, func, mut = min(entries, key=lambda e: len(_full_held(e[1], e[2].held)))
        n_unlocked = sum(1 for h in helds if not h)
        lock_names = sorted({l for h in helds for l in h})
        out.append(
            Finding(
                rule="TMR-UNLOCKED",
                path=m.path,
                line=mut.line,
                col=mut.col,
                symbol=target,
                message=(
                    f"{target} is mutated ({mut.kind}) from roles "
                    f"{{{', '.join(sorted(roles))}}} with no common governing lock "
                    f"({n_unlocked}/{len(entries)} writes hold no lock at all"
                    + (f"; locks seen: {', '.join(lock_names)}" if lock_names else "")
                    + ")"
                ),
            )
        )
    return out


# ----------------------------------------------------------- TMR-HOLD-HOST


def hold_host_findings(model: RaceModel) -> List[Finding]:
    """Host-blocking work (disk IO, device sync, sleeps, thread joins) while
    holding a lock — directly or through a call made under the lock."""
    out: List[Finding] = []
    flagged_direct = set()  # (path, qualname, line) — for call-site dedup
    for m, func in model.all_functions():
        for op in func.blocking_ops:
            held = _full_held(func, op.held)
            if not held:
                continue
            flagged_direct.add((m.path, func.qualname, op.line))
            out.append(_hold_finding(m, func, op, held))
    # interprocedural: a call under a lock into a function that blocks
    for m, func in model.all_functions():
        for site in func.calls:
            held = _full_held(func, site.held)
            if not held:
                continue
            hit = model.resolve_call(m, site, func)
            if hit is None:
                continue
            cmod, callee = hit
            for owner, op in model.transitive_blocking(cmod, callee):
                # skip ops the direct sweep already reported in the callee
                if _full_held(owner, op.held):
                    continue
                out.append(
                    Finding(
                        rule="TMR-HOLD-HOST",
                        path=m.path,
                        line=site.line,
                        col=site.col,
                        symbol=_sym(func),
                        message=(
                            f"call to {site.symbol} while holding "
                            f"{{{', '.join(sorted(held))}}} reaches {op.what} "
                            f"({owner.qualname}:{op.line})"
                        ),
                    )
                )
                break  # one finding per call site, not per reachable op
    return out


def _hold_finding(m: RaceModuleModel, func: RaceFunc, op: BlockingOp, held: frozenset) -> Finding:
    return Finding(
        rule="TMR-HOLD-HOST",
        path=m.path,
        line=op.line,
        col=op.col,
        symbol=_sym(func),
        message=f"{op.what} ({op.expr}) while holding {{{', '.join(sorted(held))}}}",
    )


# ----------------------------------------------------------------- TMR-LEAK


def leak_findings(model: RaceModel) -> List[Finding]:
    """Thread spawned with neither ``daemon=True`` nor an owned join path."""
    out: List[Finding] = []
    for m, func in model.all_functions():
        for spawn in func.spawns:
            if spawn.daemon or spawn.joined:
                continue
            out.append(
                Finding(
                    rule="TMR-LEAK",
                    path=m.path,
                    line=spawn.line,
                    col=spawn.col,
                    symbol=_sym(func),
                    message=(
                        f"thread {spawn.role!r} spawned without daemon=True and "
                        "without a join/close path for its handle"
                    ),
                )
            )
    return out
