"""TMR-HANDLER: signal / atexit / excepthook safety.

A handler runs at an arbitrary point of an arbitrary thread — including while
another (or the *same*) thread holds one of the runtime's locks. Inside code
reachable from a handler install, two things are unsafe:

- a *blocking* lock acquire (``with lock:`` or ``.acquire()`` without
  ``blocking=False``): the preempted thread may hold that lock and will never
  release it while the handler spins — deadlock at the worst possible moment
  (crash dump, SIGTERM). ``acquire(blocking=False)`` try-lock with a lock-free
  fallback is the sanctioned pattern (``obs/flight.py``).
- a non-atomic mutation of shared state: the handler interleaves with the
  very critical section it preempted.

Reachability follows the role propagation already computed in
:meth:`RaceModel.link` — any function whose role set intersects
``{signal, atexit, excepthook}`` is handler-reachable.
"""
from typing import List, Set

from metrics_tpu_torch.analysis.findings import Finding
from metrics_tpu_torch.analysis.race.thread_model import _HANDLER_KINDS, RaceModel

_HANDLER_ROLES: Set[str] = set(_HANDLER_KINDS)


def handler_findings(model: RaceModel) -> List[Finding]:
    out: List[Finding] = []
    for m, func in model.all_functions():
        ctx = sorted(func.roles & _HANDLER_ROLES)
        if not ctx:
            continue
        ctx_s = "/".join(ctx)
        for acq in func.acquires:
            if not acq.blocking:
                continue  # try-lock: the sanctioned handler pattern
            out.append(
                Finding(
                    rule="TMR-HANDLER",
                    path=m.path,
                    line=acq.line,
                    col=acq.col,
                    symbol=func.qualname,
                    message=(
                        f"blocking acquire of {acq.lock_id} in {ctx_s}-reachable "
                        f"code; a preempted thread may hold it — use "
                        f"acquire(blocking=False) with a lock-free fallback"
                    ),
                )
            )
        for mut in func.mutations:
            if mut.atomic:
                continue
            out.append(
                Finding(
                    rule="TMR-HANDLER",
                    path=m.path,
                    line=mut.line,
                    col=mut.col,
                    symbol=func.qualname,
                    message=(
                        f"non-atomic mutation of {mut.target} ({mut.kind}) in "
                        f"{ctx_s}-reachable code interleaves with the preempted "
                        f"critical section"
                    ),
                )
            )
    return out
