"""Concurrency annotations (counterpart of ``metrics_tpu/utils/concurrency.py``).

Markers with no runtime cost: each decorator tags the function and returns it
unchanged. In the JAX package a static analyser reads them; here they document the
thread that runs a function and the lock its callers hold.

``@thread_role("ingest-tick")``
    Declares which thread role(s) run this function (a thread started by a helper,
    a handler called on a server's own threads).

``@locked_by("IngestQueue._tick_lock")``
    Declares that every caller of this function holds the named lock(s) for the
    length of the call. Names: ``ClassName._attr`` for instance locks made in
    ``__init__``, ``module._GLOBAL`` for module-level locks.
"""
from typing import Any, Callable, Tuple

__all__ = ["locked_by", "thread_role"]


def thread_role(*roles: str) -> Callable[[Any], Any]:
    """Tag ``fn`` as running under the given thread role(s)."""

    def deco(fn: Any) -> Any:
        existing: Tuple[str, ...] = getattr(fn, "__thread_roles__", ())
        fn.__thread_roles__ = existing + tuple(roles)
        return fn

    return deco


def locked_by(*locks: str) -> Callable[[Any], Any]:
    """Tag ``fn`` with its callers-hold-the-lock contract."""

    def deco(fn: Any) -> Any:
        existing: Tuple[str, ...] = getattr(fn, "__locked_by__", ())
        fn.__locked_by__ = existing + tuple(locks)
        return fn

    return deco
