"""Prometheus text-format exposition of the obs registry, health and series
(counterpart of ``metrics_tpu/obs/prom.py``).

:func:`render` turns the instrumentation's current state into the exposition
format (text/plain; version=0.0.4), with the JAX package's family names and labels,
so that its dashboards carry over:

- registry counters as ``tm_events_total{scope=...,name=...}``, timers as the
  ``tm_scope_seconds`` summary (``_count``/``_sum``) and ``tm_scope_seconds_max``;
- the health quantiles as the ``tm_latency_microseconds`` summary, and the device
  memory watermark as ``tm_hbm_watermark_bytes`` (the name kept: it is the card's
  allocated bytes here);
- the ingest queues, the executable cache, the flow tracer (``tm_flow_*``), the
  metrics servers and the sampler's newest tick, each only while that tier is live in
  this process.

The serving tiers are found through ``sys.modules`` under this package's own names
(``metrics_tpu_torch.serve.*``), so that the page never reads another package's
queues or servers living in the same process.

:func:`validate_exposition` is the structural validator every rendered page goes
through in the tests. :func:`start_server` serves ``GET /metrics`` and ``GET
/healthz`` from the standard library's ``ThreadingHTTPServer`` on a daemon thread.
``/healthz`` answers ``200 ok``, or what the provider installed by
:func:`set_readiness` returns: a ``MetricsServer`` answers ``503 starting`` until
restore and prewarm are done, ``200 ready`` while it admits, ``503 draining`` after.
"""
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.obs import health as _health
from metrics_tpu_torch.obs import registry as _reg
from metrics_tpu_torch.obs import series as _series
from metrics_tpu_torch.utils.concurrency import thread_role

#: the Content-Type Prometheus scrapers expect from a text-format endpoint
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# one sample line: name, optional {labels}, value, optional timestamp
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?[0-9]+))?$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_SERVER: Optional[ThreadingHTTPServer] = None
_SERVER_THREAD: Optional[threading.Thread] = None

#: the installed readiness provider for ``GET /healthz`` (None == always ok).
#: A provider is a zero-arg callable returning ``(http_status, body_text)``.
_READINESS: Optional[Any] = None


def set_readiness(provider: Any) -> None:
    """Install the ``/healthz`` provider — a zero-arg callable returning
    ``(status_code, body)``. Last caller wins (one probe per process)."""
    global _READINESS
    _READINESS = provider


def clear_readiness(provider: Any = None) -> None:
    """Remove the readiness provider. With ``provider`` given, only removes
    it if it is still the installed one (so a stopping server cannot clobber
    its replacement's registration)."""
    global _READINESS
    if provider is None or _READINESS is provider:
        _READINESS = None


def readiness_probe() -> Tuple[int, str]:
    """Evaluate the installed readiness provider; ``(200, "ok\\n")`` when none
    is installed, ``(500, ...)`` if the provider itself fails — a broken probe
    must read as not-ready, never crash the scrape thread."""
    provider = _READINESS
    if provider is None:
        return 200, "ok\n"
    try:
        status, body = provider()
        return int(status), str(body)
    except Exception as exc:  # noqa: BLE001 — a probe answers, never raises
        return 500, f"readiness provider failed: {exc}\n"


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(**kv: str) -> str:
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(kv.items()))
    return "{" + inner + "}" if inner else ""


def _fmt(value: Any) -> str:
    v = float(value)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Family:
    """One metric family: HELP/TYPE header + its sample lines, in order."""

    def __init__(self, name: str, kind: str, help_text: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(self, suffix: str, labels: str, value: Any) -> None:
        self.samples.append(f"{self.name}{suffix}{labels} {_fmt(value)}")

    def render(self) -> str:
        head = f"# HELP {self.name} {self.help}\n# TYPE {self.name} {self.kind}\n"
        return head + "".join(s + "\n" for s in self.samples)


def render() -> str:
    """The current obs state as one Prometheus text-format page.

    Always renderable: with everything disabled the page carries only the
    ``tm_obs_enabled 0`` gauge, so a scrape endpoint stays healthy across
    ``obs.disable()`` windows instead of 500ing.
    """
    families: List[_Family] = []

    gate = _Family("tm_obs_enabled", "gauge", "1 while the obs gate is on.")
    gate.add("", "", 1 if _reg.enabled() else 0)
    families.append(gate)

    counters = _Family(
        "tm_events", "counter",
        "Obs registry counters, labelled by scope (metric class or subsystem) and event name.",
    )
    timers = _Family(
        "tm_scope_seconds", "summary",
        "Wall time of timed obs scopes (count/sum per scope and timer name).",
    )
    timer_max = _Family(
        "tm_scope_seconds_max", "gauge", "Largest single observation per timed scope.",
    )
    for scope, names in sorted(_reg.snapshot().items()):
        for name, value in sorted(names.items()):
            if isinstance(value, dict):
                labels = _labels(scope=scope, name=name)
                timers.add("_count", labels, value.get("count", 0))
                timers.add("_sum", labels, value.get("total_s", 0.0))
                timer_max.add("", labels, value.get("max_s", 0.0))
            else:
                counters.add("_total", _labels(scope=scope, name=name), value)
    if counters.samples:
        families.append(counters)
    if timers.samples:
        families.extend([timers, timer_max])

    monitor = _health._MONITOR
    if monitor is not None:
        report = monitor.report()
        latency = _Family(
            "tm_latency_microseconds", "summary",
            "Per-(op, metric) latency quantiles from the health QuantileSketches"
            " (certified to the sketch relative_error unless the rank hit an edge bin).",
        )
        for key, row in sorted(report["latency_us"].items()):
            op, _, metric = key.partition("/")
            for field, value in sorted(row.items()):
                if field == "count":
                    latency.add("_count", _labels(op=op, metric=metric), value)
                elif field.endswith("_us"):
                    q = int(field[1:-3]) / 100.0
                    latency.add(
                        "", _labels(op=op, metric=metric, quantile=f"{q:g}"), value
                    )
        if latency.samples:
            families.append(latency)
        if report["hbm_watermark_bytes"] is not None:
            hbm = _Family(
                "tm_hbm_watermark_bytes", "gauge",
                "High-water mark of the card's allocated bytes observed by the health monitor.",
            )
            hbm.add("", "", report["hbm_watermark_bytes"])
            families.append(hbm)

    # the async ingestion tier, pulled on demand: nothing here is reachable
    # from the enqueue/tick hot paths, and the import only resolves when the
    # app already imported the serve tier itself
    import sys as _sys

    _ingest = _sys.modules.get("metrics_tpu_torch.serve.ingest")
    if _ingest is not None:
        queues = _ingest.active_queues()
        if queues:
            depth = _Family(
                "tm_ingest_queue_depth", "gauge",
                "Batches currently staged (pending, unapplied) per IngestQueue.",
            )
            capacity = _Family(
                "tm_ingest_queue_capacity", "gauge",
                "Staging-ring capacity per IngestQueue.",
            )
            ing_counters = {
                "enqueued": _Family(
                    "tm_ingest_enqueued", "counter",
                    "Batches admitted into the staging ring per IngestQueue.",
                ),
                "ticks": _Family(
                    "tm_ingest_ticks", "counter",
                    "Coalescing ticks applied per IngestQueue.",
                ),
                "coalesced_rows": _Family(
                    "tm_ingest_coalesced_rows", "counter",
                    "Input rows applied through coalescing ticks per IngestQueue.",
                ),
                "dropped": _Family(
                    "tm_ingest_dropped", "counter",
                    "Batches evicted by drop_oldest backpressure or a drain=False close.",
                ),
                "degrades": _Family(
                    "tm_ingest_degrades", "counter",
                    "Ticks that fell back to applying their batches synchronously.",
                ),
            }
            for q in queues:
                labels = _labels(queue=q.name)
                depth.add("", labels, q.depth)
                capacity.add("", labels, q.capacity)
                for stat, family in ing_counters.items():
                    family.add("_total", labels, q.stats.get(stat, 0))
            families.append(depth)
            families.append(capacity)
            families.extend(ing_counters.values())

    # the executable-cache tier, same on-demand discipline as ingest above;
    # gated on live configuration (cache routed or recording on) — a
    # merely-imported tier, or residue counters from a torn-down one, emit
    # nothing, keeping the disabled page minimal
    _excache = _sys.modules.get("metrics_tpu_torch.serve.excache")
    if _excache is not None and (
        _excache.cache_dir() is not None or _excache.recording()
    ):
        ex_stats = _excache.stats()
        enabled_f = _Family(
            "tm_excache_persistent_enabled", "gauge",
            "1 when the kernel libraries are built into and loaded from the directory of"
            " serve.excache.enable_persistent_cache().",
        )
        enabled_f.add("", "", 1 if _excache.cache_dir() is not None else 0)
        families.append(enabled_f)
        ex_counters = {
            "disk_hits": _Family(
                "tm_excache_disk_hits", "counter",
                "Kernel libraries found built in the persistent directory (no nvcc run).",
            ),
            "compiles": _Family(
                "tm_excache_compiles", "counter",
                "nvcc builds and step-cache captures while the persistent cache was enabled.",
            ),
            "prewarmed": _Family(
                "tm_excache_prewarmed", "counter",
                "Warm-manifest entries captured into the engines' step caches by prewarm().",
            ),
            "prewarm_failures": _Family(
                "tm_excache_prewarm_failures", "counter",
                "Warm-manifest entries whose prewarm failed and that capture lazily instead.",
            ),
        }
        for stat, family in ex_counters.items():
            family.add("_total", "", max(0, ex_stats.get(stat, 0)))
        families.extend(ex_counters.values())
        manifest_f = _Family(
            "tm_excache_manifest_entries", "gauge",
            "Entries currently recorded in the in-process warm manifest.",
        )
        manifest_f.add("", "", len(_excache.manifest_entries()))
        families.append(manifest_f)

    # the tracing tier, on demand: rendered only while obs.flow.enable() holds a live tracer
    _flow = _sys.modules.get("metrics_tpu_torch.obs.flow")
    if _flow is not None and _flow.active():
        fstats = _flow.stats()
        active_f = _Family(
            "tm_flow_active", "gauge",
            "Flows currently open (minted, not yet closed) in the tmflow tracer.",
        )
        active_f.add("", "", fstats.get("open", 0))
        families.append(active_f)
        flow_counters = {
            "completed": _Family(
                "tm_flow_completed", "counter",
                "Flows closed by the tmflow tracer (includes degraded, excludes dropped).",
            ),
            "degraded": _Family(
                "tm_flow_degraded", "counter",
                "Completed flows that fell back to a degraded (synchronous) path.",
            ),
            "dropped": _Family(
                "tm_flow_dropped", "counter",
                "Traced batches evicted before launch (backpressure or queue close).",
            ),
            "sampled_out": _Family(
                "tm_flow_sampled_out", "counter",
                "Batches skipped by the 1-in-N sampling knob (no flow minted).",
            ),
        }
        for stat, family in flow_counters.items():
            family.add("_total", "", fstats.get(stat, 0))
        families.extend(flow_counters.values())
        if monitor is not None:
            flow_lat = _Family(
                "tm_flow_latency_microseconds", "summary",
                "Per-stage flow latency quantiles (queue_wait/coalesce/compile/"
                "launch/device/readback) from the tmflow health sketches.",
            )
            for key, row in sorted(report["latency_us"].items()):
                op, _, stage = key.partition("/")
                if op != "flow_stage":
                    continue
                for field, value in sorted(row.items()):
                    if field == "count":
                        flow_lat.add("_count", _labels(stage=stage), value)
                    elif field.endswith("_us"):
                        q = int(field[1:-3]) / 100.0
                        flow_lat.add(
                            "", _labels(stage=stage, quantile=f"{q:g}"), value
                        )
            if flow_lat.samples:
                families.append(flow_lat)

    # the metrics servers, on demand: rendered only while one is live in this process
    _srv = _sys.modules.get("metrics_tpu_torch.serve.server")
    if _srv is not None:
        servers = _srv.active_servers()
        if servers:
            state_f = _Family(
                "tm_server_state", "gauge",
                "Lifecycle state of each MetricsServer (1 on the current state's sample).",
            )
            interval_f = _Family(
                "tm_server_tick_interval_seconds", "gauge",
                "Current (possibly adaptive) shared ticker interval per MetricsServer.",
            )
            colls_f = _Family(
                "tm_server_collections", "gauge",
                "Collections served per MetricsServer.",
            )
            srv_counters = {
                "requests": _Family(
                    "tm_server_requests", "counter",
                    "Update batches admitted through MetricsServer.enqueue().",
                ),
                "rejected": _Family(
                    "tm_server_rejected", "counter",
                    "Requests rejected for lifecycle state (not ready).",
                ),
                "rounds": _Family(
                    "tm_server_rounds", "counter",
                    "Deficit-round-robin ticker rounds that applied at least one entry.",
                ),
                "slo_breaches": _Family(
                    "tm_server_slo_breaches", "counter",
                    "Per-collection SLO budget violations observed by the control loop.",
                ),
                "drift_alerts": _Family(
                    "tm_server_drift_alerts", "counter",
                    "Drift-canary alerts (live PSI past the spec threshold).",
                ),
            }
            for s in servers:
                labels = _labels(server=s.name)
                state_f.add("", _labels(server=s.name, state=s.state), 1)
                interval_f.add("", labels, s.tick_interval_s)
                colls_f.add("", labels, len(s._collections))
                for stat, family in srv_counters.items():
                    family.add("_total", labels, s.stats.get(stat, 0))
            families.extend([state_f, interval_f, colls_f])
            families.extend(srv_counters.values())

    smp = _series._SAMPLER
    if smp is not None:
        ticks = _Family(
            "tm_series_ticks", "counter", "Sampler ticks taken since series.enable().",
        )
        ticks.add("_total", "", smp.ticks_taken)
        families.append(ticks)
        slo = _Family(
            "tm_slo_violations", "counter",
            "SLO violations observed across all sampler ticks.",
        )
        slo.add("_total", "", smp.slo_violations_total)
        families.append(slo)
        rates = _Family(
            "tm_series_rate_per_second", "gauge",
            "Per-second counter rates off the sampler's most recent tick.",
        )
        for scope, names in sorted(smp.rates().items()):
            for name, rate in sorted(names.items()):
                rates.add("", _labels(scope=scope, name=name), rate)
        if rates.samples:
            families.append(rates)

    return "".join(f.render() for f in families)


# ------------------------------------------------------------------ validator


def validate_exposition(text: str) -> int:
    """Structurally validate a text-format page; returns the sample count.

    Dependency-free mirror of the exposition-format rules this module relies
    on (what a strict scraper would reject): metric/label name charsets,
    HELP/TYPE placement (TYPE precedes its samples, at most one per family),
    known TYPE values, float-parseable sample values, counter samples ending
    in ``_total``, summary samples restricted to the base name (with an
    optional ``quantile`` label) plus ``_count``/``_sum``. Raises
    ``ValueError`` on the first violation.
    """
    if not isinstance(text, str):
        raise ValueError("exposition must be a string")
    types: Dict[str, str] = {}
    helped: set = set()
    seen_samples = 0
    sampled_families: set = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: malformed comment {line!r}")
            kind, fam = parts[1], parts[2]
            if not _NAME_RE.match(fam):
                raise ValueError(f"line {lineno}: invalid family name {fam!r}")
            if kind == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "summary", "histogram", "untyped"
                ):
                    raise ValueError(f"line {lineno}: invalid TYPE line {line!r}")
                if fam in types:
                    raise ValueError(f"line {lineno}: duplicate TYPE for {fam}")
                if fam in sampled_families:
                    raise ValueError(f"line {lineno}: TYPE for {fam} after its samples")
                types[fam] = parts[3]
            else:
                if fam in helped:
                    raise ValueError(f"line {lineno}: duplicate HELP for {fam}")
                helped.add(fam)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, labels, value = m.group("name"), m.group("labels"), m.group("value")
        try:
            float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"line {lineno}: non-numeric value {value!r}") from None
        label_names = []
        if labels:
            consumed = _LABEL_RE.sub("", labels).replace(",", "").strip()
            if consumed:
                raise ValueError(f"line {lineno}: malformed labels {{{labels}}}")
            label_names = [lm.group(1) for lm in _LABEL_RE.finditer(labels)]
            for ln in label_names:
                if not _LABEL_NAME_RE.match(ln):
                    raise ValueError(f"line {lineno}: invalid label name {ln!r}")
            if len(set(label_names)) != len(label_names):
                raise ValueError(f"line {lineno}: duplicate label names in {line!r}")
        family = _family_of(name, types)
        if family is None:
            raise ValueError(f"line {lineno}: sample {name!r} has no TYPE header")
        kind = types[family]
        suffix = name[len(family):]
        if kind == "counter" and suffix != "_total":
            raise ValueError(f"line {lineno}: counter sample {name!r} must end in _total")
        if kind == "summary" and suffix not in ("", "_count", "_sum"):
            raise ValueError(f"line {lineno}: invalid summary sample {name!r}")
        if kind == "summary" and suffix == "" and "quantile" not in label_names:
            raise ValueError(f"line {lineno}: summary sample {name!r} missing quantile label")
        if kind == "gauge" and suffix != "":
            raise ValueError(f"line {lineno}: gauge sample {name!r} must match its family")
        sampled_families.add(family)
        seen_samples += 1
    return seen_samples


def _family_of(sample_name: str, types: Dict[str, str]) -> Optional[str]:
    """Longest declared family whose name prefixes this sample name."""
    best = None
    for fam in types:
        if sample_name == fam or (
            sample_name.startswith(fam)
            and sample_name[len(fam):] in ("_total", "_count", "_sum", "_bucket")
        ):
            if best is None or len(fam) > len(best):
                best = fam
    return best


# ---------------------------------------------------------------- http server


class _MetricsHandler(BaseHTTPRequestHandler):
    # ThreadingHTTPServer calls this on its own per-connection threads
    @thread_role("prom-handler")
    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            status, text = readiness_probe()
            body = text.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        try:
            body = render().encode("utf-8")
        except Exception as exc:  # noqa: BLE001 — a scrape must answer, not hang
            self.send_response(500)
            self.end_headers()
            self.wfile.write(str(exc).encode("utf-8"))
            return
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args: Any) -> None:  # scrapes must not spam stderr
        pass


def start_server(port: int = 9464, host: str = "127.0.0.1") -> Tuple[str, int]:
    """Serve ``GET /metrics`` on a daemon thread; returns ``(host, port)``.

    ``port=0`` binds an ephemeral port (tests); the returned port is the one
    actually bound. Idempotent: a second call replaces the first server.
    """
    global _SERVER, _SERVER_THREAD
    stop_server()
    server = ThreadingHTTPServer((host, port), _MetricsHandler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="tmscope-prom", daemon=True
    )
    thread.start()
    _SERVER, _SERVER_THREAD = server, thread
    return server.server_address[0], server.server_address[1]


def stop_server() -> None:
    global _SERVER, _SERVER_THREAD
    server, thread = _SERVER, _SERVER_THREAD
    _SERVER = _SERVER_THREAD = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5.0)


def server_active() -> bool:
    return _SERVER is not None
