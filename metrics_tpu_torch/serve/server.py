"""The metrics server: a deployable front end (``python -m metrics_tpu_torch.serve``;
counterpart of ``metrics_tpu/serve/server.py``).

:class:`MetricsServer` composes the port's serving pieces (fused one-replay updates,
fleet routing, the :class:`~metrics_tpu_torch.serve.ingest.IngestQueue`, the warm
manifest, atomic checkpoints, the Prometheus export, SLO budgets and fault sites)
into one process object serving N named collections, each described declaratively,
behind a three-verb request API::

    server = MetricsServer(load_config("serve.json"))
    server.enqueue("quality", preds, target, stream_ids=ids)   # host append
    server.compute("quality")                                   # flush, then read
    server.reduce_fleet("quality")                              # across streams
    server.drain(); server.stop()

**One ticker, deficit round-robin.** Each collection has its own bounded
``IngestQueue`` (one tenant's backlog cannot evict another's rows), and one thread,
``tm-serve/ticker``, ticks them all: every round each queue earns ``quantum`` entries
of credit and applies at most its deficit (one CUDA-graph replay a tick on the card);
credit carries over only while the queue stays backlogged.

**Adaptive tick interval.** :class:`AdaptiveTickController` holds the observed p99
enqueue-to-applied latency inside the SLO budget: it halves the interval when the
p99 crosses ``high_water`` of the budget or a backlog stands, and grows it slowly
while the p99 sits under ``low_water``. It is a pure object (no clock, no thread).

**Drift canary.** A collection may keep a :class:`~metrics_tpu_torch.sketches.HistogramDrift`
watch: the request path keeps a 1-in-N sample of the batches' first arrays, the
control loop histograms them (the first rows as the reference window, the rest as the
live one) and compares the two by PSI against the spec's threshold, with the same
warn / raise / callable ladder as the SLO budgets.

**Lifecycle.** ``starting -> ready -> draining -> stopped``. Startup is restore,
prewarm, ready: ``/healthz`` answers ``503 starting`` before the first restore, each
collection restores its newest committed step and its queue captures the warm
manifest's steps (:func:`metrics_tpu_torch.serve.excache.prewarm`), so that the first
request makes no capture. Shutdown is drain, checkpoint (with the warm manifest), stop:
admissions raise :class:`ServerStateError`, every queue applies its backlog exactly
once and every collection checkpoints atomically. The ``server.drain`` fault site fires
before anything is flushed, so a killed drain never loses a committed row.

**Device.** The config's ``device`` (``"cuda"`` unless it names another) goes into
every member's constructor, as ``fleet_size`` does; where CUDA is absent an unset
device raises, and nothing falls back to the CPU. The JAX package takes its backend
from the environment instead.

Threads: the ticker owns the deficit table, the controller and the drift windows; the
request path (any number of producer threads) owns the admission counters, under a
lock, and appends to the drift sample deque. Producers may compute their batches on
the card, each on its own stream, while the ticker captures and replays; a request's
``compute`` waits, on the caller's stream, for the last tick of its queue. A state transition is one attribute
store under the transition lock, never held across a blocking call.
"""
import atexit
import json
import os
import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from metrics_tpu_torch.fault import inject as _fault
from metrics_tpu_torch.obs import flight as _obs_flight
from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _obs
from metrics_tpu_torch.serve import excache as _excache
from metrics_tpu_torch.serve.ingest import IngestQueue
from metrics_tpu_torch.utils.concurrency import thread_role

__all__ = [
    "AdaptiveTickController",
    "CollectionSpec",
    "DriftAlert",
    "DriftAlertError",
    "DriftSpec",
    "MetricsServer",
    "ServerConfig",
    "ServerConfigError",
    "ServerStateError",
    "active_servers",
    "load_config",
]

#: live servers, pulled by ``obs.prom.render`` for the tm_server_* families
_SERVERS: "weakref.WeakSet[MetricsServer]" = weakref.WeakSet()

_STATES = ("starting", "ready", "draining", "stopped")

#: queue keyword arguments a collection spec may override
_QUEUE_KEYS = ("capacity", "backpressure", "block_timeout_s", "max_staleness_s", "max_coalesce")


class ServerConfigError(ValueError):
    """A declarative server config is malformed: unknown metric class,
    duplicate collection name, bad option value. Raised at build time, never
    mid-serve."""


class ServerStateError(RuntimeError):
    """A request arrived in a lifecycle state that cannot honour it (enqueue
    while draining, compute after stop). Typed so a load balancer shim can
    distinguish 'retry elsewhere' from a real failure."""


class DriftAlert(RuntimeWarning):
    """The live input window of a collection drifted past its PSI threshold."""


class DriftAlertError(RuntimeError):
    """``action='raise'`` form of :class:`DriftAlert`."""


# --------------------------------------------------------------------- config


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ServerConfigError(msg)


class DriftSpec:
    """Drift-canary configuration for one collection.

    The watch histograms a deterministic 1-in-``sample_every`` sample of the
    first float array of each enqueued batch: the first
    ``reference_rows`` sampled rows freeze the reference window, subsequent
    rows accumulate into the live window, and once ``min_live_rows`` have
    arrived each control-loop evaluation compares the two (PSI; see
    ``sketches/drift.py`` for the 0.1/0.25 industry thresholds) and slides the
    live window. ``action`` follows the SLO ladder: ``"warn"`` emits
    :class:`DriftAlert`, ``"raise"`` raises :class:`DriftAlertError` (stashed
    by the ticker, re-raised at the next request), a callable receives the
    alert payload dict.
    """

    def __init__(
        self,
        *,
        num_bins: int = 32,
        low: float = 0.0,
        high: float = 1.0,
        max_psi: float = 0.25,
        sample_every: int = 1,
        reference_rows: int = 256,
        min_live_rows: int = 64,
        action: Union[str, Callable[[Dict[str, Any]], None]] = "warn",
    ) -> None:
        _require(int(num_bins) >= 2, f"drift num_bins must be >= 2, got {num_bins}")
        _require(float(high) > float(low), f"drift needs high > low, got [{low}, {high}]")
        _require(float(max_psi) > 0.0, f"drift max_psi must be > 0, got {max_psi}")
        _require(int(sample_every) >= 1, f"drift sample_every must be >= 1, got {sample_every}")
        _require(int(reference_rows) >= 1, "drift reference_rows must be >= 1")
        _require(int(min_live_rows) >= 1, "drift min_live_rows must be >= 1")
        if isinstance(action, str):
            _require(action in ("warn", "raise"), f"drift action must be 'warn', 'raise' or a callable, got {action!r}")
        else:
            _require(callable(action), "drift action must be 'warn', 'raise' or a callable")
        self.num_bins = int(num_bins)
        self.low = float(low)
        self.high = float(high)
        self.max_psi = float(max_psi)
        self.sample_every = int(sample_every)
        self.reference_rows = int(reference_rows)
        self.min_live_rows = int(min_live_rows)
        self.action = action

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DriftSpec":
        _require(isinstance(d, dict), f"drift spec must be a mapping, got {type(d).__name__}")
        return cls(**d)


class CollectionSpec:
    """Declarative description of one served collection.

    ``metrics`` maps result label → ``{"class": <name in metrics_tpu>,
    "kwargs": {...}}`` (a bare string is shorthand for the class name alone).
    A spec-level ``fleet_size`` is injected into every member's kwargs so the
    whole collection shares the fleet axis. A spec-level ``tolerance`` (plus
    optional ``tolerance_bits``) is injected into every *sketch-computable*
    member (AUROC / AveragePrecision with ``thresholds=None``) — those members
    then serve certified-bracket midpoints from O(1) histogram state instead
    of cat-buffer + sort (ops/rank.py sketch tier); other members are left
    untouched, and per-metric kwargs still win. ``queue`` overrides
    IngestQueue knobs (capacity, backpressure, max_coalesce, ...);
    ``ckpt_dir`` enables restore-on-start and checkpoint-on-drain;
    ``slo_p99_ingest_ms`` arms the per-collection latency budget the control
    loop checks; ``drift`` attaches a canary watch. ``device`` (set by the server's
    config) goes into every member's kwargs, as ``fleet_size`` does.
    """

    def __init__(
        self,
        name: str,
        metrics: Dict[str, Any],
        *,
        fused: bool = True,
        fleet_size: Optional[int] = None,
        tolerance: Optional[float] = None,
        tolerance_bits: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        queue: Optional[Dict[str, Any]] = None,
        slo_p99_ingest_ms: Optional[float] = None,
        drift: Optional[Union[DriftSpec, Dict[str, Any]]] = None,
        device: Optional[str] = None,
    ) -> None:
        _require(bool(name) and isinstance(name, str), f"collection name must be a non-empty string, got {name!r}")
        _require(isinstance(metrics, dict) and bool(metrics), f"collection {name!r} needs a non-empty metrics mapping")
        self.name = name
        self.fused = bool(fused)
        self.fleet_size = None if fleet_size is None else int(fleet_size)
        if self.fleet_size is not None:
            _require(self.fleet_size >= 1, f"collection {name!r}: fleet_size must be >= 1")
        self.tolerance = None if tolerance is None else float(tolerance)
        if self.tolerance is not None:
            _require(self.tolerance >= 0, f"collection {name!r}: tolerance must be >= 0")
        self.tolerance_bits = None if tolerance_bits is None else int(tolerance_bits)
        if self.tolerance_bits is not None:
            _require(
                4 <= self.tolerance_bits <= 14,
                f"collection {name!r}: tolerance_bits must be an int in [4, 14]",
            )
            _require(
                self.tolerance is not None,
                f"collection {name!r}: tolerance_bits without tolerance has no effect",
            )
        self.ckpt_dir = ckpt_dir
        self.queue = dict(queue or {})
        for key in self.queue:
            _require(key in _QUEUE_KEYS, f"collection {name!r}: unknown queue option {key!r}; valid: {_QUEUE_KEYS}")
        self.slo_p99_ingest_ms = None if slo_p99_ingest_ms is None else float(slo_p99_ingest_ms)
        if self.slo_p99_ingest_ms is not None:
            _require(self.slo_p99_ingest_ms > 0, f"collection {name!r}: slo_p99_ingest_ms must be > 0")
        if isinstance(drift, dict):
            drift = DriftSpec.from_dict(drift)
        self.drift = drift
        self.device = device
        self.metrics: Dict[str, Tuple[type, Dict[str, Any]]] = {}
        # classes resolve through the package root, which re-exports every public
        # metric; imported here, not at the top, to keep the root out of a cycle
        import metrics_tpu_torch as _mt

        for label, md in metrics.items():
            if isinstance(md, str):
                md = {"class": md}
            _require(isinstance(md, dict), f"collection {name!r}: metric {label!r} spec must be a mapping or class name")
            cls_name = md.get("class")
            klass = getattr(_mt, cls_name, None) if isinstance(cls_name, str) else None
            _require(
                isinstance(klass, type),
                f"collection {name!r}: unknown metric class {cls_name!r} for {label!r}"
                " (must name a class exported from metrics_tpu_torch)",
            )
            kwargs = dict(md.get("kwargs") or {})
            if self.fleet_size is not None:
                kwargs.setdefault("fleet_size", self.fleet_size)
            if self.device is not None:
                kwargs.setdefault("device", self.device)
            if (
                self.tolerance is not None
                and getattr(klass, "_sketch_computable", False)
                and kwargs.get("thresholds") is None
            ):
                kwargs.setdefault("tolerance", self.tolerance)
                if self.tolerance_bits is not None:
                    kwargs.setdefault("tolerance_bits", self.tolerance_bits)
            self.metrics[label] = (klass, kwargs)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectionSpec":
        _require(isinstance(d, dict), f"collection spec must be a mapping, got {type(d).__name__}")
        d = dict(d)
        name = d.pop("name", None)
        metrics = d.pop("metrics", None)
        return cls(name, metrics, **d)

    def build(self) -> Any:
        """Instantiate the spec as a :class:`MetricCollection` (always a
        collection, even for one member — uniform compute()/ckpt surface)."""
        from metrics_tpu_torch.core.collections import MetricCollection

        try:
            members = {label: klass(**kwargs) for label, (klass, kwargs) in self.metrics.items()}
            return MetricCollection(members, fused=self.fused)
        except ServerConfigError:
            raise
        except Exception as err:
            raise ServerConfigError(f"collection {self.name!r} failed to build: {err}") from err


class ServerConfig:
    """Top-level declarative config: the collections plus the shared ticker,
    checkpoint, prom, and executable-cache knobs. ``from_dict`` accepts the
    JSON shape ``python -m metrics_tpu_torch.serve --config`` loads::

        {"name": "eval",
         "collections": [{"name": "quality",
                          "metrics": {"mse": "MeanSquaredError"},
                          "fleet_size": 4,
                          "ckpt_dir": "/ckpts/quality",
                          "slo_p99_ingest_ms": 50.0,
                          "drift": {"max_psi": 0.25}}],
         "ticker": {"tick_interval_s": 0.005, "adaptive": true, "quantum": 8},
         "prom": {"port": 0},
         "excache": {"persistent_dir": "/cache/kernels", "record": true},
         "device": "cuda"}

    ``device`` (default ``"cuda"``) is where every collection lives; a deviation from
    the JAX package, which takes its backend from the environment.
    """

    def __init__(
        self,
        collections: List[Union[CollectionSpec, Dict[str, Any]]],
        *,
        name: str = "metrics-server",
        tick_interval_s: float = 0.005,
        adaptive: bool = True,
        min_tick_interval_s: float = 0.0005,
        max_tick_interval_s: float = 0.25,
        quantum: int = 8,
        control_every_s: float = 0.25,
        retain: Optional[int] = 3,
        prom_port: Optional[int] = None,
        prom_host: str = "127.0.0.1",
        persistent_cache_dir: Optional[str] = None,
        record_manifest: bool = True,
        slo_action: Union[str, Callable[[List[Dict[str, Any]]], None]] = "warn",
        device: str = "cuda",
    ) -> None:
        _require(bool(collections), "config needs at least one collection")
        _require(isinstance(device, str) and bool(device), f"device must be a device name, got {device!r}")
        self.device = device
        self.collections = [
            c if isinstance(c, CollectionSpec) else CollectionSpec.from_dict(dict(c, device=device)) for c in collections
        ]
        for c in self.collections:
            if c.device is None:
                c.device = device
                for _klass, kwargs in c.metrics.values():
                    kwargs.setdefault("device", device)
        names = [c.name for c in self.collections]
        _require(len(set(names)) == len(names), f"duplicate collection names in config: {names}")
        _require(float(tick_interval_s) > 0, f"tick_interval_s must be > 0, got {tick_interval_s}")
        _require(0 < float(min_tick_interval_s) <= float(max_tick_interval_s), "need 0 < min_tick_interval_s <= max_tick_interval_s")
        _require(int(quantum) >= 1, f"quantum must be >= 1, got {quantum}")
        _require(float(control_every_s) > 0, f"control_every_s must be > 0, got {control_every_s}")
        if isinstance(slo_action, str):
            _require(slo_action in ("warn", "raise"), f"slo_action must be 'warn', 'raise' or a callable, got {slo_action!r}")
        self.name = str(name)
        self.tick_interval_s = float(tick_interval_s)
        self.adaptive = bool(adaptive)
        self.min_tick_interval_s = float(min_tick_interval_s)
        self.max_tick_interval_s = float(max_tick_interval_s)
        self.quantum = int(quantum)
        self.control_every_s = float(control_every_s)
        self.retain = retain
        self.prom_port = prom_port
        self.prom_host = prom_host
        self.persistent_cache_dir = persistent_cache_dir
        self.record_manifest = bool(record_manifest)
        self.slo_action = slo_action

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServerConfig":
        _require(isinstance(d, dict), f"server config must be a mapping, got {type(d).__name__}")
        d = dict(d)
        collections = d.pop("collections", None)
        _require(isinstance(collections, list), "server config needs a 'collections' list")
        kwargs: Dict[str, Any] = {}
        for key in ("name", "retain", "slo_action", "device"):
            if key in d:
                kwargs[key] = d.pop(key)
        ticker = d.pop("ticker", {})
        _require(isinstance(ticker, dict), "'ticker' must be a mapping")
        for key in ("tick_interval_s", "adaptive", "min_tick_interval_s", "max_tick_interval_s", "quantum", "control_every_s"):
            if key in ticker:
                kwargs[key] = ticker.pop(key)
        _require(not ticker, f"unknown ticker options: {sorted(ticker)}")
        prom = d.pop("prom", {})
        _require(isinstance(prom, dict), "'prom' must be a mapping")
        if "port" in prom:
            kwargs["prom_port"] = prom.pop("port")
        if "host" in prom:
            kwargs["prom_host"] = prom.pop("host")
        _require(not prom, f"unknown prom options: {sorted(prom)}")
        cache = d.pop("excache", {})
        _require(isinstance(cache, dict), "'excache' must be a mapping")
        if "persistent_dir" in cache:
            kwargs["persistent_cache_dir"] = cache.pop("persistent_dir")
        if "record" in cache:
            kwargs["record_manifest"] = cache.pop("record")
        _require(not cache, f"unknown excache options: {sorted(cache)}")
        _require(not d, f"unknown server config keys: {sorted(d)}")
        return cls(collections, **kwargs)


def load_config(source: Union[str, Dict[str, Any], ServerConfig], *, device: Optional[str] = None) -> ServerConfig:
    """Build a :class:`ServerConfig` from a JSON file path, a dict, or an
    already-built config (identity). ``device``, when given, replaces the device a
    path or dict names (the command line's ``--device``)."""
    if isinstance(source, ServerConfig):
        return source
    if isinstance(source, dict):
        return ServerConfig.from_dict(source if device is None else dict(source, device=device))
    _require(isinstance(source, str), f"config source must be a path, dict or ServerConfig, got {type(source).__name__}")
    try:
        with open(source, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    except OSError as err:
        raise ServerConfigError(f"cannot read config {source!r}: {err}") from err
    except ValueError as err:
        raise ServerConfigError(f"config {source!r} is not valid JSON: {err}") from err
    if device is not None and isinstance(payload, dict):
        payload = dict(payload, device=device)
    return ServerConfig.from_dict(payload)


# ----------------------------------------------------------------- controller


class AdaptiveTickController:
    """Deterministic multiplicative controller for the shared tick interval.

    The tick interval is the dominant term of enqueue→applied latency at low
    load (an entry waits up to one interval before its tick) and pure
    overhead at saturation (ticks fire back-to-back anyway). The controller
    holds the observed p99 ingest latency inside the SLO budget with the
    classic asymmetric rule: **shrink fast** (``interval *= shrink``) whenever
    p99 crosses ``high_water * budget`` or backlog is standing, **grow
    slowly** (``interval *= grow``) only while p99 sits under ``low_water *
    budget`` with an empty backlog, clamped to ``[min_interval, max_interval]``.
    Asymmetry matters: an interval that is too long violates the SLO, one
    that is too short merely burns a few wakeups, so recovery must outpace
    relaxation.

    Pure object — no clocks, no threads, no I/O: ``observe(p99_ms, depth)``
    returns the new interval, which makes convergence on a stepped
    arrival-rate trace a plain unit test.
    """

    def __init__(
        self,
        budget_ms: float,
        *,
        interval_s: float = 0.005,
        min_interval_s: float = 0.0005,
        max_interval_s: float = 0.25,
        high_water: float = 0.7,
        low_water: float = 0.2,
        shrink: float = 0.5,
        grow: float = 1.25,
    ) -> None:
        if not budget_ms > 0:
            raise ValueError(f"budget_ms must be > 0, got {budget_ms}")
        if not 0 < min_interval_s <= max_interval_s:
            raise ValueError("need 0 < min_interval_s <= max_interval_s")
        if not 0 < low_water < high_water <= 1.0:
            raise ValueError("need 0 < low_water < high_water <= 1")
        if not 0 < shrink < 1.0 < grow:
            raise ValueError("need shrink in (0, 1) and grow > 1")
        self.budget_ms = float(budget_ms)
        self.min_interval_s = float(min_interval_s)
        self.max_interval_s = float(max_interval_s)
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.shrink = float(shrink)
        self.grow = float(grow)
        self.interval_s = min(max(float(interval_s), self.min_interval_s), self.max_interval_s)
        self.shrinks = 0
        self.grows = 0
        # observe() normally runs only on the control loop, but it is public
        # (the convergence tests drive it directly from the caller's thread),
        # so the counters and interval get a governing lock rather than a
        # single-writer claim.
        self._lock = threading.Lock()

    @thread_role("tm-serve/ticker")
    def observe(self, p99_ms: Optional[float], depth: int = 0) -> float:
        """Fold one control-window observation; return the new interval."""
        if p99_ms is None:
            return self.interval_s
        with self._lock:
            if p99_ms > self.high_water * self.budget_ms or depth > 0:
                nxt = max(self.interval_s * self.shrink, self.min_interval_s)
                if nxt < self.interval_s:
                    self.shrinks += 1
                self.interval_s = nxt
            elif p99_ms < self.low_water * self.budget_ms:
                nxt = min(self.interval_s * self.grow, self.max_interval_s)
                if nxt > self.interval_s:
                    self.grows += 1
                self.interval_s = nxt
            return self.interval_s


# ---------------------------------------------------------------- drift watch


class _DriftWatch:
    """Runtime state of one collection's drift canary (see :class:`DriftSpec`).

    Split by thread role: :meth:`sample` runs on the request path (role
    ``user``) and only appends to a bounded deque (atomic, drop-oldest);
    :meth:`absorb` and :meth:`evaluate` run on the control loop (role
    ``tm-serve``) and own the histogram and window counters. No lock needed —
    the deque is the only shared structure and deque append/popleft are
    atomic.
    """

    def __init__(self, spec: DriftSpec, collection: str, device: Any) -> None:
        from metrics_tpu_torch.sketches import HistogramDrift

        self.spec = spec
        self.collection = collection
        self.sketch = HistogramDrift(num_bins=spec.num_bins, low=spec.low, high=spec.high, device=device)
        self._pending: "deque[Any]" = deque(maxlen=64)
        self._seen = 0
        self._ref_rows = 0
        self._live_rows = 0
        self.absorbed = 0  # samples histogrammed
        self.alerts = 0
        self.last: Optional[Dict[str, float]] = None

    def sample(self, args: Tuple, kwargs: Dict) -> None:
        """Request path: keep a host reference to the first float array of a
        1-in-``sample_every`` batch. O(1), never blocks, never dispatches."""
        self._seen += 1
        if (self._seen - 1) % self.spec.sample_every:
            return
        for value in list(args) + list(kwargs.values()):
            if hasattr(value, "dtype") and hasattr(value, "shape"):
                self._pending.append(value)
                return

    def absorb(self) -> None:
        """Control loop: histogram every pending sample — reference window
        first, live window after."""
        while True:
            try:
                value = self._pending.popleft()
            except IndexError:
                return
            rows = int(np.prod(tuple(value.shape))) or 1
            self.absorbed += 1
            if self._ref_rows < self.spec.reference_rows:
                self.sketch.update(value, reference=True)
                self._ref_rows += rows
            else:
                self.sketch.update(value)
                self._live_rows += rows

    def evaluate(self) -> Optional[Dict[str, Any]]:
        """Control loop: compare live vs reference once enough live rows have
        accumulated; slide the live window either way. Returns the alert
        payload when PSI crosses the threshold, else None."""
        if self._live_rows < self.spec.min_live_rows or self._ref_rows < self.spec.reference_rows:
            return None
        out = self.sketch.compute()
        self.last = {k: float(v) for k, v in out.items()}
        self.sketch.reset_live()
        self._live_rows = 0
        if self.last["psi"] <= self.spec.max_psi:
            return None
        self.alerts += 1
        return {
            "collection": self.collection,
            "psi": self.last["psi"],
            "kl": self.last["kl"],
            "tv": self.last["tv"],
            "max_psi": self.spec.max_psi,
        }


# ------------------------------------------------------------------ server


class _Collection:
    """Runtime bundle for one served collection: spec + built target + queue
    + canary + restore/commit bookkeeping."""

    __slots__ = ("spec", "target", "queue", "drift", "restored_step", "committed", "prewarm")

    def __init__(self, spec: CollectionSpec, target: Any, queue: IngestQueue) -> None:
        self.spec = spec
        self.target = target
        self.queue = queue
        self.drift = _DriftWatch(spec.drift, spec.name, spec.device) if spec.drift is not None else None
        self.restored_step: Optional[int] = None
        self.committed: Optional[Dict[str, Any]] = None
        self.prewarm: List[Dict[str, Any]] = []  # the reports of the warm-manifest prewarm

    def update_count(self) -> int:
        counts = [int(getattr(m, "_update_count", 0)) for m in self.target._modules.values()]
        return max(counts) if counts else 0


class MetricsServer:
    """The server process object (see the module docstring).

    Construction does not start anything; :meth:`start` runs the
    ``restore → prewarm → ready`` sequence and (by default) spawns the shared
    ticker thread. ``ticker=False`` keeps the server in manual-tick mode —
    tests and the chaos sweep drive :meth:`_tick_round` / :meth:`_run_control`
    deterministically. Usable as a context manager: ``__exit__`` drains and
    stops.
    """

    def __init__(
        self,
        config: Union[ServerConfig, Dict[str, Any], str],
        *,
        start: bool = True,
        ticker: bool = True,
        starting_hook: Optional[Callable[["MetricsServer"], None]] = None,
        draining_hook: Optional[Callable[["MetricsServer"], None]] = None,
    ) -> None:
        from metrics_tpu_torch.utils.data import _resolve_device

        self.config = load_config(config)
        self.device = _resolve_device(self.config.device)  # no card and no device named: raises
        self.name = self.config.name
        self._state = "starting"
        self._lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticker_enabled = bool(ticker)
        self._starting_hook = starting_hook
        self._draining_hook = draining_hook
        self._error: Optional[BaseException] = None
        self._collections: Dict[str, _Collection] = {}
        self._order: Tuple[str, ...] = tuple(spec.name for spec in self.config.collections)
        self._deficit: Dict[str, float] = {}
        self._drain_report: Optional[Dict[str, Any]] = None
        self._prom_address: Optional[Tuple[str, int]] = None
        self._prom_owned = False
        self._recording_owned = False
        self._readiness: Optional[Callable[[], Tuple[int, str]]] = None
        self._last_control = 0.0
        self.tick_interval_s = self.config.tick_interval_s
        self.startup_s: Optional[float] = None
        # counters are partitioned by writer role: requests/rejected belong to
        # the request path, rounds/slo_breaches/drift_alerts to the ticker —
        # distinct keys, so no cross-role read-modify-write on any of them.
        # The request path may itself be multi-threaded (N producer threads
        # are all role "user"), so its two counters increment under _req_lock
        # to keep the totals exact; the ticker keys stay lock-free (one thread)
        self.stats: Dict[str, int] = {
            "requests": 0,
            "rejected": 0,
            "rounds": 0,
            "applied_entries": 0,
            "slo_breaches": 0,
            "drift_alerts": 0,
        }
        budgets = [s.slo_p99_ingest_ms for s in self.config.collections if s.slo_p99_ingest_ms is not None]
        self.controller: Optional[AdaptiveTickController] = None
        if self.config.adaptive and budgets:
            self.controller = AdaptiveTickController(
                min(budgets),
                interval_s=self.config.tick_interval_s,
                min_interval_s=self.config.min_tick_interval_s,
                max_interval_s=self.config.max_tick_interval_s,
            )
        if start:
            self.start()

    # ---------------------------------------------------------------- startup

    @property
    def state(self) -> str:
        return self._state

    def start(self) -> "MetricsServer":
        """Run ``restore → prewarm → ready``: bring the health endpoint up
        first (so probes see ``503 starting`` during the expensive part),
        restore every collection's latest committed checkpoint, replay each
        warm manifest, then admit traffic."""
        with self._lock:
            if self._state != "starting" or self._collections:
                raise ServerStateError(f"start() from state {self._state!r}; servers are single-use")
        t0 = time.perf_counter()
        _obs_flight.record("server_state", server=self.name, state="starting")
        if self.config.persistent_cache_dir:
            _excache.enable_persistent_cache(self.config.persistent_cache_dir)
        if self.config.prom_port is not None:
            from metrics_tpu_torch.obs import prom as _prom

            # readiness first: the very first probe must see 503 starting.
            # Bind the method once — clear_readiness compares identity, and
            # every `self._healthz` access builds a fresh bound method.
            self._readiness = self._healthz
            _prom.set_readiness(self._readiness)
            self._prom_address = _prom.start_server(port=self.config.prom_port, host=self.config.prom_host)
            self._prom_owned = True
        if self._starting_hook is not None:
            self._starting_hook(self)
        from metrics_tpu_torch.ckpt import latest_step, restore_checkpoint

        for spec in self.config.collections:
            target = spec.build()
            restored = None
            if spec.ckpt_dir and latest_step(spec.ckpt_dir) is not None:
                restored = restore_checkpoint(target, spec.ckpt_dir)
            queue = IngestQueue(target, name=spec.name, start=False, **spec.queue)
            coll = _Collection(spec, target, queue)
            coll.restored_step = restored
            if spec.ckpt_dir:
                manifest = os.path.join(spec.ckpt_dir, _excache.MANIFEST_NAME)
                if os.path.isfile(manifest):
                    coll.prewarm = self._prewarm_collection(queue, target, manifest)
            self._collections[spec.name] = coll
            self._deficit[spec.name] = 0.0
        if self.config.record_manifest and not _excache.recording():
            _excache.enable_recording()
            self._recording_owned = True  # turned off again at stop()
        _SERVERS.add(self)
        if self._ticker_enabled:
            self._thread = threading.Thread(target=self._ticker_loop, name="tm-serve/ticker", daemon=True)
            self._thread.start()
        self.startup_s = time.perf_counter() - t0
        with self._lock:
            self._state = "ready"
        _obs_flight.record("server_state", server=self.name, state="ready", startup_s=self.startup_s)
        return self

    @staticmethod
    def _prewarm_collection(queue: IngestQueue, target: Any, manifest_path: str) -> List[Dict[str, Any]]:
        """Replay one warm manifest against one collection's two serving
        objects: ingest-chain entries against the queue, fused/fleet/rank
        entries against the collection. The manifest is recorded
        process-wide, so with several collections each one's copy also holds
        the *other* collections' entries — partitioning by the live chain /
        member labels keeps those out of the replay instead of tripping
        prewarm's schema-drift warnings. Returns the prewarm reports."""
        try:
            payload = _excache.load_manifest(manifest_path)
        except Exception:  # noqa: BLE001 — let prewarm produce its own warning
            return [_excache.prewarm(queue, manifest_path)]
        chain, _eager, _is_coll = queue._plan()
        labels = [label for label, _ in chain]
        members = set(target._modules)
        queue_entries: List[Dict[str, Any]] = []
        target_entries: List[Dict[str, Any]] = []
        for entry in payload.get("entries", []) or []:
            engine = entry.get("engine")
            if engine == "ingest":
                if list(entry.get("chain") or []) == labels:
                    queue_entries.append(entry)
            elif engine == "fused":
                if all(name in members for name, _ in entry.get("groups", [])):
                    target_entries.append(entry)
            else:
                target_entries.append(entry)
        reports = []
        if queue_entries:
            reports.append(_excache.prewarm(queue, dict(payload, entries=queue_entries)))
        if target_entries:
            reports.append(_excache.prewarm(target, dict(payload, entries=target_entries)))
        return reports

    @thread_role("prom-handler")
    def _healthz(self) -> Tuple[int, str]:
        """Readiness probe body for ``obs.prom``'s ``/healthz`` route:
        ``200 ready`` only while admitting, ``503 <state>`` otherwise.
        Read-only and lock-free — safe from the scrape handler thread."""
        state = self._state
        return (200, "ready\n") if state == "ready" else (503, state + "\n")

    # ------------------------------------------------------------ request API

    def _reraise(self) -> None:
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _coll(self, name: str) -> _Collection:
        coll = self._collections.get(name)
        if coll is None:
            raise ServerConfigError(f"unknown collection {name!r}; serving: {sorted(self._collections)}")
        return coll

    def enqueue(self, name: str, *args: Any, stream_ids: Any = None, **kwargs: Any) -> None:
        """Admit one update batch for collection ``name``. Host append only —
        the shared ticker applies it. Raises :class:`ServerStateError` unless
        the server is ``ready`` (a drained server never half-applies)."""
        self._reraise()
        state = self._state
        if state != "ready":
            with self._req_lock:
                self.stats["rejected"] += 1
            raise ServerStateError(f"server {self.name!r} is {state}; enqueue requires ready")
        coll = self._coll(name)
        if _fault._SCHEDULE is not None:
            _fault.fire("server.request", server=self.name, collection=name)
        t0 = time.monotonic()
        if coll.drift is not None:
            coll.drift.sample(args, kwargs)
        if stream_ids is not None:
            kwargs = dict(kwargs, stream_ids=stream_ids)
        coll.queue.enqueue(*args, **kwargs)
        with self._req_lock:
            self.stats["requests"] += 1
        if _obs._ENABLED:
            _obs.REGISTRY.inc("server", "requests")
        mon = _health._MONITOR
        if mon is not None:
            mon.observe_latency("server.request", name, time.monotonic() - t0)
        self._wake.set()

    def compute(self, name: str, *, stream: Optional[int] = None) -> Any:
        """Flush-before-read compute for collection ``name``; ``stream=i``
        narrows every fleet member to one stream. Allowed while ``ready`` or
        ``draining`` (reads during drain observe the final flushed state)."""
        self._reraise()
        coll = self._coll(name)
        if self._state == "stopped":
            raise ServerStateError(f"server {self.name!r} is stopped")
        if stream is None:
            return coll.queue.compute()
        # MetricCollection.compute() has no stream axis — fan out per member
        coll.queue.flush()
        return {label: m.compute(stream=stream) for label, m in coll.target._modules.items()}

    def reduce_fleet(self, name: str) -> Dict[str, Any]:
        """Cross-stream reduction for every fleet member of collection
        ``name`` (flush first). Returns label → reduced value."""
        self._reraise()
        coll = self._coll(name)
        if self._state == "stopped":
            raise ServerStateError(f"server {self.name!r} is stopped")
        coll.queue.flush()
        out = {
            label: m.reduce_fleet()
            for label, m in coll.target._modules.items()
            if getattr(m, "fleet_size", None) is not None
        }
        if not out:
            raise ServerStateError(f"collection {name!r} has no fleet members to reduce")
        return out

    def status(self) -> Dict[str, Any]:
        """Operator snapshot: lifecycle state, per-collection queue stats and
        restore/commit bookkeeping, ticker and canary posture."""
        collections = {}
        for coll_name, coll in self._collections.items():
            collections[coll_name] = {
                "depth": coll.queue.depth,
                "stats": dict(coll.queue.stats),
                "update_count": coll.update_count(),
                "restored_step": coll.restored_step,
                "committed": coll.committed,
                "deficit": self._deficit.get(coll_name, 0.0),
                "drift": None if coll.drift is None else dict(coll.drift.last or {}, alerts=coll.drift.alerts),
                "prewarm": list(coll.prewarm),
            }
        return {
            "server": self.name,
            "state": self._state,
            "tick_interval_s": self.tick_interval_s,
            "stats": dict(self.stats),
            "prom": self._prom_address,
            "startup_s": self.startup_s,
            "collections": collections,
        }

    # ------------------------------------------------------------- the ticker

    def _ticker_loop(self) -> None:
        """The shared tick thread (role ``tm-serve``): one DRR round per
        wakeup plus the control loop at its own cadence. Errors are stashed
        and re-raised at the next request — the thread itself never dies
        mid-serve."""
        while not self._stop_evt.is_set():
            self._wake.wait(self.tick_interval_s)
            self._wake.clear()
            if self._stop_evt.is_set():
                return
            try:
                self._tick_round()
                now = time.monotonic()
                if now - self._last_control >= self.config.control_every_s:
                    self._last_control = now
                    self._run_control()
            except BaseException as err:  # noqa: BLE001 — stash, surface at host boundary
                if self._error is None:
                    self._error = err

    def _tick_round(self) -> int:
        """One deficit-round-robin pass: every queue accrues ``quantum``
        entries of credit, applies at most its accumulated deficit, and keeps
        the remainder only while backlogged (classic DRR reset-on-empty).
        Returns total entries applied this round."""
        quantum = self.config.quantum
        applied = 0
        for name in self._order:
            coll = self._collections[name]
            credit = self._deficit[name] + quantum
            served = 0
            # tick() caps each call at max_coalesce; loop until the credit or
            # the backlog is spent so a large quantum is honoured in full
            while credit - served >= 1 and coll.queue.depth > 0:
                got = coll.queue.tick(limit=int(credit - served))
                if got == 0:
                    break
                served += got
            applied += served
            self._deficit[name] = 0.0 if coll.queue.depth == 0 else credit - served
        if applied:
            self.stats["rounds"] += 1
            self.stats["applied_entries"] += applied
            if _obs._ENABLED:
                _obs.REGISTRY.inc("server", "rounds")
                _obs.REGISTRY.inc("server", "applied_entries", applied)
        return applied

    def _run_control(self) -> None:
        """The slow loop (role ``tm-serve``): adaptive-interval update,
        per-collection SLO budget checks, drift canary evaluation."""
        mon = _health._MONITOR
        latency: Dict[str, Any] = {}
        if mon is not None:
            latency = mon.report().get("latency_us", {})

        def p99_ms(op: str, coll_name: str) -> Optional[float]:
            row = latency.get(f"{op}/{coll_name}")
            return None if row is None else float(row["p99_us"]) / 1000.0

        if self.controller is not None:
            observed = [p99_ms("ingest", c) for c in self._order]
            observed = [o for o in observed if o is not None]
            depth = max((self._collections[c].queue.depth for c in self._order), default=0)
            if observed:
                self.tick_interval_s = self.controller.observe(max(observed), depth=depth)
        violations: List[Dict[str, Any]] = []
        for name in self._order:
            coll = self._collections[name]
            budget = coll.spec.slo_p99_ingest_ms
            if budget is None:
                continue
            observed = p99_ms("ingest", name)
            if observed is not None and observed > budget:
                violations.append(
                    {"slo": "p99_ingest_latency_ms", "collection": name, "observed": observed, "budget": budget}
                )
        if violations:
            self.stats["slo_breaches"] += len(violations)
            if _obs._ENABLED:
                _obs.REGISTRY.inc("server", "slo_breaches", len(violations))
            _obs_flight.record("server_slo", server=self.name, violations=len(violations))
            self._react_slo(violations)
        for name in self._order:
            coll = self._collections[name]
            if coll.drift is None:
                continue
            coll.drift.absorb()
            alert = coll.drift.evaluate()
            if alert is None:
                continue
            self.stats["drift_alerts"] += 1
            if _obs._ENABLED:
                _obs.REGISTRY.inc("server", "drift_alerts")
            _obs_flight.record("drift_alert", server=self.name, **alert)
            self._react_drift(coll.drift.spec.action, alert)

    def _react_slo(self, violations: List[Dict[str, Any]]) -> None:
        action = self.config.slo_action
        if callable(action):
            action(violations)
            return
        lines = "; ".join(
            f"{v['collection']}: p99 ingest {v['observed']:.2f}ms > budget {v['budget']:.2f}ms" for v in violations
        )
        if action == "raise":
            raise _health.SLOBudgetExceeded(f"server {self.name!r} SLO exceeded — {lines}")
        warnings.warn(f"server {self.name!r} SLO violation — {lines}", _health.SLOViolationWarning, stacklevel=2)

    def _react_drift(self, action: Union[str, Callable], alert: Dict[str, Any]) -> None:
        if callable(action):
            action(alert)
            return
        msg = (
            f"server {self.name!r} collection {alert['collection']!r} input drift:"
            f" PSI {alert['psi']:.4f} > {alert['max_psi']:.4f}"
            f" (kl={alert['kl']:.4f}, tv={alert['tv']:.4f})"
        )
        if action == "raise":
            raise DriftAlertError(msg)
        warnings.warn(msg, DriftAlert, stacklevel=2)

    def _stop_ticker(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=30.0)
        self._thread = None

    # -------------------------------------------------------------- lifecycle

    def drain(self) -> Dict[str, Any]:
        """``serve → drain``: stop admitting, apply every staged batch exactly
        once, checkpoint every collection (the warm manifest rides along while
        recording is on). Idempotent. The ``server.drain`` fault site fires
        *before* anything is flushed: a killed drain drops only staged-but-
        uncommitted rows — with attribution, never silently — and leaves the
        last committed checkpoint untouched."""
        with self._lock:
            if self._state in ("draining", "stopped"):
                return self._drain_report or {}
            self._state = "draining"
        _obs_flight.record("server_state", server=self.name, state="draining")
        if self._draining_hook is not None:
            self._draining_hook(self)
        try:
            if _fault._SCHEDULE is not None:
                _fault.fire("server.drain", server=self.name, collections=len(self._collections))
        except _fault.InjectedFaultError:
            # salvage path: the drain is dead, but nothing may leak — staged
            # rows are dropped WITH attribution and traced flows are closed
            # as dropped (the chaos sweep's zero-orphaned-flows invariant)
            self._stop_ticker()
            for coll in self._collections.values():
                try:
                    coll.queue.close(drain=False)
                except Exception:  # noqa: BLE001 — salvage must reach every queue
                    pass
            raise
        self._stop_ticker()
        from metrics_tpu_torch.ckpt import save_checkpoint

        report: Dict[str, Any] = {}
        first_error: Optional[BaseException] = None
        for name in self._order:
            coll = self._collections[name]
            try:
                coll.queue.close(drain=True)
                entry: Dict[str, Any] = {
                    "update_count": coll.update_count(),
                    "applied_rows": int(coll.queue.stats["coalesced_rows"]),
                    "dropped": int(coll.queue.stats["dropped"]),
                    "step": None,
                }
                if coll.spec.ckpt_dir:
                    write = save_checkpoint(
                        coll.target, coll.spec.ckpt_dir, blocking=True, retain=self.config.retain
                    )
                    entry["step"] = write.step
                coll.committed = entry
                report[name] = entry
            except Exception as err:  # noqa: BLE001 — drain the rest, re-raise the first
                if first_error is None:
                    first_error = err
                try:
                    coll.queue.close(drain=False)
                except Exception:  # noqa: BLE001
                    pass
        self._drain_report = report
        _obs_flight.record("server_state", server=self.name, state="drained", collections=len(report))
        if first_error is not None:
            raise first_error
        return report

    def stop(self) -> None:
        """Drain (if not already drained) and release everything: ticker,
        queues, readiness registration, prom server ownership, and the manifest
        recording the server turned on (the JAX server leaves it on)."""
        try:
            if self._state not in ("draining", "stopped"):
                self.drain()
        finally:
            self._stop_ticker()
            for coll in self._collections.values():
                try:
                    coll.queue.close(drain=False)
                except Exception:  # noqa: BLE001 — stop() must release everything
                    pass
            if self._prom_owned:
                from metrics_tpu_torch.obs import prom as _prom

                _prom.clear_readiness(self._readiness)
                _prom.stop_server()
                self._prom_owned = False
            if self._recording_owned:
                _excache.disable_recording()
                self._recording_owned = False
            with self._lock:
                self._state = "stopped"
            _SERVERS.discard(self)
            _obs_flight.record("server_state", server=self.name, state="stopped")

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.stop()


def active_servers() -> List[MetricsServer]:
    """Live (non-stopped) servers, for the prom exposition's tm_server_*
    families."""
    return [s for s in list(_SERVERS) if s._state != "stopped"]


@thread_role("atexit")
def _stop_all_tickers() -> None:
    """Interpreter-exit backstop: a leaked (never-stopped) server's daemon
    ticker must not be mid-launch while the runtime tears down. Only sets
    events (atomic, handler-safe) — no joins, no locks."""
    for s in list(_SERVERS):
        s._stop_evt.set()
        s._wake.set()


atexit.register(_stop_all_tickers)
