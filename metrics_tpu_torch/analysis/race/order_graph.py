"""TMR-ORDER: cycle detection in the interprocedural lock-acquisition graph.

An edge ``A -> B`` means some code path acquires ``B`` while holding ``A`` —
either a nested ``with``/``acquire()`` in one function (``held ∪ entry_held``
at the acquire site) or a call made under ``A`` into a function whose
transitive closure acquires ``B``. Two threads walking a cycle in opposite
directions deadlock; a cycle is a finding regardless of whether the schedule
that hits it has been observed. Reentrant self-edges on an ``RLock`` are
exempt (that is what RLock is for); a ``Lock``/``Condition`` self-edge is
self-deadlock and is reported.
"""
from typing import Dict, List, Set, Tuple

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.race.thread_model import RaceModel


def _edges(model: RaceModel) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
    """``(held, acquired) -> (path, line, via)`` anchor for the first witness."""
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(a: str, b: str, path: str, line: int, via: str) -> None:
        edges.setdefault((a, b), (path, line, via))

    for m, func in model.all_functions():
        entry = func.entry_held or frozenset()
        for acq in func.acquires:
            for held in frozenset(acq.held) | entry:
                if held != acq.lock_id:
                    add(held, acq.lock_id, m.path, acq.line, func.qualname)
                elif _kind(model, held) != "RLock":
                    # non-reentrant self-acquire: immediate self-deadlock
                    add(held, held, m.path, acq.line, func.qualname)
        for site in func.calls:
            under = frozenset(site.held) | entry
            if not under:
                continue
            hit = model.resolve_call(m, site, func)
            if hit is None:
                continue
            for lock_id in model.transitive_acquires(hit[0], hit[1]):
                if lock_id in under:
                    continue  # already held on this path; the direct pass covers reentry
                for held in under:
                    add(held, lock_id, m.path, site.line,
                        f"{func.qualname} -> {site.symbol}")
    return edges


def _kind(model: RaceModel, lock_id: str) -> str:
    decl = model.locks.get(lock_id)
    return decl.kind if decl else "Lock"


def _sccs(nodes: Set[str], succ: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan, iterative (analyzer runs on arbitrarily deep lock graphs)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            children = sorted(succ.get(node, ()))
            for ci in range(pi, len(children)):
                child = children[ci]
                if child not in index:
                    work[-1] = (node, ci + 1)
                    work.append((child, 0))
                    advanced = True
                    break
                if child in on_stack:
                    low[node] = min(low[node], index[child])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp: List[str] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def _cycle_signature(comp: List[str]) -> str:
    """Canonical, line-churn-stable symbol: rotate so the lexicographically
    smallest lock leads, then close the loop."""
    comp = sorted(set(comp))
    return "->".join(comp + [comp[0]])


def order_findings(model: RaceModel) -> List[Finding]:
    edges = _edges(model)
    succ: Dict[str, Set[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        nodes.add(a)
        nodes.add(b)
        succ.setdefault(a, set()).add(b)
    out: List[Finding] = []
    for comp in _sccs(nodes, succ):
        cyclic = len(comp) > 1 or (comp and comp[0] in succ.get(comp[0], ()))
        if not cyclic:
            continue
        members = sorted(set(comp))
        # anchor at the first witness edge inside the component
        witness = None
        for (a, b), anchor in sorted(edges.items()):
            if a in members and b in members:
                witness = ((a, b), anchor)
                break
        if witness is None:  # pragma: no cover — SCC implies an internal edge
            continue
        (a, b), (path, line, via) = witness
        detail = ", ".join(
            f"{x}->{y} ({edges[(x, y)][2]})"
            for (x, y) in sorted(edges)
            if x in members and y in members
        )
        out.append(
            Finding(
                rule="TMR-ORDER",
                path=path,
                line=line,
                col=0,
                symbol=_cycle_signature(members),
                message=(
                    f"lock-order cycle over {{{', '.join(members)}}}: {detail}"
                    if len(members) > 1
                    else f"self-deadlock: {a} re-acquired while held ({via})"
                ),
            )
        )
    return out
