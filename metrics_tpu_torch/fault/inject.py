"""Deterministic, seeded fault injection (counterpart of ``metrics_tpu/fault/inject.py``).

Failures that production sees rarely (a flaky filesystem under the checkpoint
writer, a CUDA-graph capture or replay that fails, a NaN-poisoned upstream batch)
leave their handling code untested unless something causes them on demand. This
module does: **named injection sites** sit at the runtime's real failure points and
a seeded :class:`FaultSchedule`, used as a context manager, arms them. With no
schedule active every site costs one module-attribute load and an identity check.

Injection sites (the name is the contract: tests address faults by it):

    ``ckpt.write``      payload write in ``ckpt.manager.save_checkpoint``
    ``ckpt.fsync``      manifest and commit-record fsync (``_atomic_write_json``)
    ``ckpt.rename``     the publishing ``os.rename`` in ``_try_commit``
    ``fused.compile``   capture of a fused step (``core/fused.py:StepCache``)
    ``fused.launch``    replay of a captured fused step
    ``fleet.compile``   capture of a fleet routed or broadcast step
    ``agg.publish``     host snapshot publish in ``obs.aggregate.publish``
    ``agg.read``        each host file's read in ``obs.aggregate.aggregate_dir``
    ``ingest.enqueue``  admission of a batch into an ``IngestQueue``'s ring
    ``ingest.tick``     the coalescing tick of an ``IngestQueue``: a fired tick
                        applies its batches synchronously instead
    ``excache.prewarm`` one warm-manifest entry's capture in ``serve.excache.prewarm``
    ``server.request``  request admission of ``serve.server.MetricsServer.enqueue``
    ``server.drain``    the server's drain transition, before anything is flushed
    ``input.poison``    NaN-poisoning of update inputs (``Metric``'s update wrapper)

Every site but ``input.poison`` raises :class:`InjectedFaultError` (an ``OSError``,
so the checkpoint retry loop takes an injected fault as it takes a real IO error)
when the schedule fires it. ``input.poison`` transforms instead: a seeded subset of
rows of every float tensor input becomes NaN, on the tensor's own device, for the
``nan_policy`` quarantine to catch. The rows are the JAX package's for the same
seed and occurrence.

Determinism: each site draws from its own ``random.Random`` seeded by ``(seed,
site)``, so whether the n-th call at a site fires depends only on the seed and that
site's count, never on the interleaving of sites or threads. ``fire_at`` plans
bypass randomness. Every fired fault is appended to ``schedule.fired`` and, while
the flight recorder runs, recorded as a ``"fault"`` event.
"""
import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.obs import flight as _obs_flight

__all__ = [
    "SITES",
    "FaultSchedule",
    "InjectedFaultError",
    "PoisonedInputError",
    "fire",
    "poison_inputs",
    "active",
    "current",
]

#: the closed set of injection-site names
SITES = (
    "ckpt.write",
    "ckpt.fsync",
    "ckpt.rename",
    "fused.compile",
    "fused.launch",
    "fleet.compile",
    "agg.publish",
    "agg.read",
    "ingest.enqueue",
    "ingest.tick",
    "excache.prewarm",
    "server.request",
    "server.drain",
    "input.poison",
)

#: the active schedule; None means injection is off. Sites gate on
#: ``_SCHEDULE is not None`` (one attribute load and an identity check).
_SCHEDULE: Optional["FaultSchedule"] = None


class InjectedFaultError(OSError):
    """A fault site fired. An ``OSError`` on purpose: the checkpoint retry loop, and
    any caller hardened against real IO errors, handles it as a disk failure."""

    def __init__(self, site: str, occurrence: int, seed: Optional[int] = None) -> None:
        super().__init__(f"injected fault at site {site!r} (occurrence {occurrence}, seed={seed})")
        self.site = site
        self.occurrence = occurrence
        self.seed = seed


class PoisonedInputError(ValueError):
    """Raised by ``Metric(nan_policy="raise")`` when NaN/Inf rows reach ``update()``;
    carries the count of such rows."""

    def __init__(self, metric: str, rows: int) -> None:
        super().__init__(
            f"Metric {metric}: {rows} update input row(s) contain NaN/Inf"
            " (nan_policy='raise'); quarantine the upstream batch or use"
            " nan_policy='count' to tally without failing"
        )
        self.metric = metric
        self.rows = rows


def _normalize_fire_at(fire_at: Optional[Dict[str, Union[int, Iterable[int]]]]) -> Dict[str, frozenset]:
    plan: Dict[str, frozenset] = {}
    for site, occs in (fire_at or {}).items():
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; valid sites: {SITES}")
        if isinstance(occs, int) and not isinstance(occs, bool):
            occs = (occs,)
        occ_set = frozenset(int(o) for o in occs)
        if any(o < 0 for o in occ_set):
            raise ValueError(f"fire_at occurrences must be >= 0, got {sorted(occ_set)}")
        plan[site] = occ_set
    return plan


class FaultSchedule:
    """A deterministic plan of which site calls fail, armed as a context manager.

    - **Explicit**: ``fire_at={"ckpt.rename": 0, "fused.launch": (0, 2)}`` fires
      exactly those zero-based occurrences of each site.
    - **Seeded**: ``FaultSchedule(seed=7, sites=("fused.launch",), rate=0.25)`` fires
      each call of a listed site with probability ``rate``, from a per-site
      ``random.Random`` seeded by ``(seed, site)``.

    ``max_fires`` caps the fires over all sites. ``fired`` lists every fired fault as
    ``{"site", "occurrence", ...context}``; ``counts`` maps each site to the calls it
    saw. Thread-safe: checkpoint writers and ingest ticks hit sites from their own
    threads.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        fire_at: Optional[Dict[str, Union[int, Iterable[int]]]] = None,
        sites: Optional[Tuple[str, ...]] = None,
        rate: float = 0.0,
        max_fires: Optional[int] = None,
    ) -> None:
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        for site in sites or ():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; valid sites: {SITES}")
        if rate > 0.0 and not sites:
            raise ValueError("rate > 0 requires sites=(...) naming which sites misfire")
        self.seed = int(seed)
        self.rate = float(rate)
        self.random_sites = tuple(sites or ())
        self.max_fires = max_fires
        self._plan = _normalize_fire_at(fire_at)
        self._rngs: Dict[str, random.Random] = {site: random.Random(f"{self.seed}:{site}") for site in self.random_sites}
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.fired: List[Dict[str, Any]] = []
        self._prev: Optional["FaultSchedule"] = None

    def _on_call(self, site: str, context: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Count one call at ``site``; return (and record) the fired event when this
        occurrence fails, else None."""
        with self._lock:
            occurrence = self.counts.get(site, 0)
            self.counts[site] = occurrence + 1
            fires = occurrence in self._plan.get(site, ())
            if not fires and site in self._rngs and self.rate > 0.0:
                fires = self._rngs[site].random() < self.rate
            if fires and self.max_fires is not None and len(self.fired) >= self.max_fires:
                fires = False
            if not fires:
                return None
            event = {"site": site, "occurrence": occurrence, **context}
            self.fired.append(event)
        # recorded outside the schedule lock (record() takes no lock)
        _obs_flight.record("fault", **event)
        return event

    def __enter__(self) -> "FaultSchedule":
        global _SCHEDULE
        self._prev = _SCHEDULE
        _SCHEDULE = self
        return self

    def __exit__(self, *exc_info: Any) -> None:
        global _SCHEDULE
        _SCHEDULE = self._prev
        self._prev = None


def fire(site: str, **context: Any) -> None:
    """One call at a raising site: nothing without a schedule; raises
    :class:`InjectedFaultError` when the active schedule fires this occurrence.

    Hot paths gate the call itself (``if inject._SCHEDULE is not None:``)."""
    sched = _SCHEDULE
    if sched is None:
        return
    event = sched._on_call(site, context)
    if event is not None:
        raise InjectedFaultError(site, event["occurrence"], seed=sched.seed)


def _poison_one(value: Any, rng: random.Random) -> Tuple[Any, int]:
    """``value`` with ``max(1, rows // 8)`` seeded rows set to NaN (a copy), and the
    count; other values as they are."""
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point() or value.dim() < 1 or value.shape[0] == 0:
            return value, 0
        rows = int(value.shape[0])
        idx = rng.sample(range(rows), max(1, rows // 8))
        out = value.clone()
        out[torch.tensor(idx, dtype=torch.long, device=value.device)] = float("nan")
        return out, len(idx)
    if isinstance(value, np.ndarray):
        if not np.issubdtype(value.dtype, np.floating) or value.ndim < 1 or value.shape[0] == 0:
            return value, 0
        rows = int(value.shape[0])
        idx = rng.sample(range(rows), max(1, rows // 8))
        out = value.copy()
        out[np.asarray(idx)] = np.nan
        return out, len(idx)
    return value, 0


def poison_inputs(args: Tuple, kwargs: Dict, metric: str = "") -> Tuple[Tuple, Dict]:
    """One call at the ``input.poison`` site: when it fires, copies of ``(args,
    kwargs)`` with a seeded subset of rows of every float tensor (or numpy array)
    set to NaN, written on the tensor's own device. Never raises: the ``nan_policy``
    quarantine decides what happens to the batch."""
    sched = _SCHEDULE
    if sched is None:
        return args, kwargs
    event = sched._on_call("input.poison", {"metric": metric})
    if event is None:
        return args, kwargs
    rng = random.Random(f"{sched.seed}:input.poison:{event['occurrence']}")
    poisoned_rows = 0

    def poison(value: Any) -> Any:
        nonlocal poisoned_rows
        out, n = _poison_one(value, rng)
        poisoned_rows += n
        return out

    new_args = tuple(poison(a) for a in args)
    new_kwargs = {k: poison(v) for k, v in kwargs.items()}
    event["rows"] = poisoned_rows
    return new_args, new_kwargs


def active() -> bool:
    return _SCHEDULE is not None


def current() -> Optional[FaultSchedule]:
    return _SCHEDULE
