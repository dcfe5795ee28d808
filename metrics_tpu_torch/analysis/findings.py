"""tmlint rule metadata and the Finding record (counterpart of
``metrics_tpu/analysis/findings.py``).

The port's rule table covers the families the port analyses: the AST and
introspection rules (TM-*), the concurrency rules (TMR-*) and the two crosscheck
rules (TMS-LINTGAP, TMS-STALE-WAIVER) whose ground truth is the card's record of
synchronising calls. Rule IDs, the ``Finding`` fields and its waiver key are the
JAX package's. Every rule names what would show at run time in the port: a CUDA
graph capture that fails and demotes its group to eager (counted in the
:class:`~metrics_tpu_torch.core.fused.StepCache` ``stats["degrades"]`` and the obs
counter ``<site>.degrades``), a stall of the card's queue, or an obs counter of
``metrics_tpu_torch.obs``, whose names are the JAX package's.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Rule:
    """One rule: identity, family, and its runtime cross-link."""

    id: str
    # tmlint: "trace-safety" | "state-contract" | "retrace-hazard"
    # crosscheck: "crosscheck"
    # tmrace: "lock-discipline" | "lock-order" | "handler-safety"
    family: str
    summary: str
    #: obs counter(s) that count this failure class at run time, with ``<M>`` for
    #: the metric class name; None when it shows as an error or a stall instead.
    counter: Optional[str]
    #: what you would see at run time if the finding is real, printed by ``--explain``
    runtime_signal: str
    rationale: str


_CAPTURE_FAILS = (
    "inside a captured step (`core/fused.py:CapturedStep`) the capture fails with "
    "\"operation not permitted when stream is capturing\" and the group is demoted to "
    "eager for good, counted in `StepCache.stats[\"degrades\"]` and the obs counter "
    "`fused.degrades` / `fleet.degrades` / `ingest.degrades`; "
)

RULES: Dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            id="TM-HOSTSYNC",
            family="trace-safety",
            summary="host synchronisation inside a trace-reachable region",
            counter="fused.degrades / fleet.degrades / ingest.degrades",
            runtime_signal=(
                _CAPTURE_FAILS
                + "under `torch.func.vmap` `.item()` raises on a batched tensor; on the eager "
                "path a silent device->host copy that drains the card's queue (a gap between "
                "`tm.update/<M>` ranges in a profiler trace, obs/scopes.py)"
            ),
            rationale=(
                "`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()/int()/bool()` on a\n"
                "tensor, and numpy calls on tensors all wait for the card and copy to the\n"
                "host. Inside a step that the engines capture into a CUDA graph they make\n"
                "the capture fail, and the group runs eagerly from then on; under a\n"
                "`torch.func` transform they raise; eagerly they stall the queue once per\n"
                "update. Host work belongs behind an `_is_concrete` guard\n"
                "(metrics_tpu_torch/utils/checks.py), which tmlint recognizes and exempts."
            ),
        ),
        Rule(
            id="TM-PYBRANCH",
            family="trace-safety",
            summary="Python control flow branching on a tensor value",
            counter="fused.degrades / fleet.degrades / ingest.degrades",
            runtime_signal=(
                _CAPTURE_FAILS
                + "under `torch.func.vmap` \"data-dependent control flow is not supported\"; "
                "eagerly one implicit `bool()` sync per update"
            ),
            rationale=(
                "`if`/`while`/`assert` on an expression derived from tensor values calls\n"
                "`Tensor.__bool__`, which reads the value on the host: a sync that a capture\n"
                "refuses and a `torch.func` transform cannot batch. Data-dependent choices\n"
                "must use `torch.where`, or sit behind an `_is_concrete` guard so a traced\n"
                "step skips them."
            ),
        ),
        Rule(
            id="TM-DYNSHAPE",
            family="trace-safety",
            summary="data-dependent output shape inside a trace-reachable region",
            counter="fused.degrades / fleet.degrades / ingest.degrades",
            runtime_signal=(
                _CAPTURE_FAILS
                + "under `torch.func.vmap` the op has no batching rule for a dynamic shape; "
                "eagerly the op syncs to learn its output size"
            ),
            rationale=(
                "`torch.unique`/`nonzero`/`argwhere`/`masked_select`, one-argument\n"
                "`torch.where(cond)`, boolean-mask indexing and `repeat_interleave` without\n"
                "`output_size` produce shapes that depend on data: the card must finish and\n"
                "report the size to the host before the result can be allocated. A captured\n"
                "graph has static shapes. Use the padded static-shape ops in ops/ (e.g.\n"
                "ops/clf_curve.py curve padding), `torch.where(cond, x, fill)`, or pass\n"
                "`output_size=`."
            ),
        ),
        Rule(
            id="TM-RETRACE",
            family="retrace-hazard",
            summary="per-call Python values entering a step key (recapture storm hazard)",
            counter="<M>.retraces / <M>.retrace_signatures / fused.cache_misses",
            runtime_signal=(
                "obs/recompile.py increments `<MetricClass>.retraces` (per instance) and "
                "`<MetricClass>.retrace_signatures` (per class) and warns past "
                "RETRACE_WARN_THRESHOLD distinct signatures; each new key is a StepCache "
                "miss, a new CUDA-graph capture (`fused.cache_misses`)"
            ),
            rationale=(
                "A Python scalar that enters a step-cache key (the `tag` or `static_key` of\n"
                "`core/fleet.py:run_step`) or the guards of a `torch.compile`d function is a\n"
                "fresh constant: every new value captures (or compiles) a new program, the\n"
                "silent slowdown obs/recompile.py exists to catch at run time. Pass per-call\n"
                "scalars as tensors (`torch.as_tensor`) so they become step inputs. Building\n"
                "`torch.compile(...)` inside a function body is the same hazard: each call\n"
                "makes a fresh wrapper with an empty cache."
            ),
        ),
        Rule(
            id="TM-STATE-UNREG",
            family="state-contract",
            summary="update() mutates an attribute never registered via add_state",
            counter=None,
            runtime_signal=(
                "silent state loss: a checkpoint round-trip (ckpt/serializer.py) restores a "
                "metric that recomputes from defaults; `Metric.sync` "
                "(utils/distributed.py) never gathers the attribute"
            ),
            rationale=(
                "The Metric contract (core/metric.py add_state) is the single registry\n"
                "that ckpt/ serializes, utils/distributed.py gathers, and reset() restores.\n"
                "An attribute assigned in update() but never registered rides along eagerly\n"
                "and then silently disappears on checkpoint restore, never syncs across\n"
                "ranks, and survives reset(). Register it with add_state, or derive it\n"
                "from registered state."
            ),
        ),
        Rule(
            id="TM-REDUCE-MISMATCH",
            family="state-contract",
            summary="dist_reduce_fx inconsistent with the state's default/shape",
            counter="<M>.syncs",
            runtime_signal=(
                "wrong values after a sync across ranks (utils/distributed.py, "
                "parallel/collective.py) or a checkpoint topology change (ckpt/restore.py "
                "re-reduce refuses or mis-reduces the state)"
            ),
            rationale=(
                "The reduction declared at add_state time is what the sync applies to the\n"
                "gathered states and what ckpt/restore.py re-applies when restoring onto a\n"
                "different rank count. A `cat` reduction on a dense tensor default, a\n"
                "sum/mean/max/min on a list default, a `mean` over an integer-dtype state,\n"
                "or a custom callable (which the topology re-reduce cannot invert) all\n"
                "produce states the rest of the system cannot honor."
            ),
        ),
        Rule(
            id="TM-PERSIST",
            family="state-contract",
            summary="tensor state the ckpt serializer would silently drop",
            counter="ckpt.bytes",
            runtime_signal=(
                "ckpt.saves succeeds but ckpt.bytes is missing the attr's payload; "
                "restore_checkpoint validates only registered states, so the drop is "
                "silent"
            ),
            rationale=(
                "ckpt/serializer.py snapshots exactly the add_state registry. A tensor-\n"
                "valued instance attribute outside the registry (and not a constructor\n"
                "knob named in `_update_signature_attrs`, which is re-derived at\n"
                "construction, nor a declared `_ckpt_exempt_attrs` entry) holds real\n"
                "accumulated data that a preemption would lose. Register it, derive it\n"
                "from registered state, or declare the exemption explicitly."
            ),
        ),
        Rule(
            id="TMS-LINTGAP",
            family="crosscheck",
            summary="synchronising call on the card in a tmlint-clean function",
            counter="san.lintgaps",
            runtime_signal=(
                "same as TM-HOSTSYNC (the line syncs inside a traced update on the card, "
                "`torch.cuda.set_sync_debug_mode` reported it), and in addition tmlint's "
                "TM-HOSTSYNC model has a blind spot worth closing"
            ),
            rationale=(
                "The two tiers keep each other honest: every line the card reports as a\n"
                "synchronising call inside a traced update (an update run in `tracing()`,\n"
                "where `_is_concrete` is False, under `torch.cuda.set_sync_debug_mode`)\n"
                "must correspond to a TM-HOSTSYNC finding (or waiver) at the same source\n"
                "location. A sync in a function tmlint considered clean is a LINTGAP: fix\n"
                "the metric AND extend the AST rule (trace_rules.py) so the cheap tier\n"
                "catches the pattern next time."
            ),
        ),
        Rule(
            id="TMS-STALE-WAIVER",
            family="crosscheck",
            summary="TM-HOSTSYNC waiver contradicted by the card's evidence",
            counter="san.stale_waivers",
            runtime_signal=(
                "the waived 'host-only' line runs inside traced updates without syncing: the "
                "waiver's safety claim no longer describes the code, and the original "
                "TM-HOSTSYNC runtime signal may apply"
            ),
            rationale=(
                "A TM-HOSTSYNC waiver asserts the flagged host work stays off traced paths\n"
                "(eager-only tier, concreteness guard) or is a sync that is known and kept.\n"
                "The card tier corroborates each waiver against the traced updates' line\n"
                "footprint (`sys.monitoring` line events in the port's files): the waived\n"
                "lines must be absent from every traced update (corroborated-by-absence) or\n"
                "show as a synchronising call (corroborated-by-presence). A waived line that\n"
                "runs as ordinary traced code means the code moved under the waiver —\n"
                "re-triage it."
            ),
        ),
        Rule(
            id="TMR-UNLOCKED",
            family="lock-discipline",
            summary="shared attribute mutated from >=2 thread roles outside its governing lock",
            counter="race.unlocked",
            runtime_signal=(
                "lost updates / torn compound state under real concurrency: a counter "
                "that undercounts, a dict whose check-then-act interleaves"
            ),
            rationale=(
                "An attribute written by two different thread roles (user thread, ingest\n"
                "ticker, ckpt writer, sampler, prom handler, ...) needs ONE governing\n"
                "lock covering every non-atomic mutation. tmrace infers governance from\n"
                "the acquisition context of each write (interprocedural: the held-at-\n"
                "entry set is the intersection over call sites, or an explicit\n"
                "`@locked_by(...)` contract) and flags targets where some mutation runs\n"
                "outside every candidate lock. The documented GIL-atomic idioms are\n"
                "modeled as atomic and never flagged: a single `deque.append` (the\n"
                "obs/ring.py hot path), a single attribute store of a fresh object,\n"
                "`Event.set/clear`. Read-modify-write (`+=`, `x = x + ...`) and\n"
                "multi-step container surgery are not atomic and need the lock."
            ),
        ),
        Rule(
            id="TMR-ORDER",
            family="lock-order",
            summary="cycle in the interprocedural lock-acquisition order graph",
            counter="race.order_cycles",
            runtime_signal=(
                "a deadlock under the right interleaving: two threads each holding one "
                "lock of the cycle and blocking on the next — the process wedges with no "
                "exception, visible only as a stalled tick/scrape/save"
            ),
            rationale=(
                "tmrace records an edge L1 -> L2 whenever code acquires L2 while\n"
                "holding L1 — including interprocedurally (a call made under L1 to a\n"
                "function that transitively acquires L2). A cycle in that graph means\n"
                "two code paths take the same locks in opposite orders, which is a\n"
                "deadlock waiting for the right preemption point. Fix by ordering the\n"
                "acquisitions consistently (snapshot under the lock, work outside it)."
            ),
        ),
        Rule(
            id="TMR-HOLD-HOST",
            family="lock-discipline",
            summary="device sync or disk I/O while holding a lock",
            counter="race.hold_host",
            runtime_signal=(
                "latency cliffs on every thread contending the lock: an enqueue/scrape/"
                "tick blocked behind a listdir, a build or a device->host copy — p99 "
                "spikes in the health latency sketches and gaps between ticks in the series"
            ),
            rationale=(
                "A lock held across host-blocking work (`os.listdir`, `open`/`fsync`,\n"
                "`time.sleep`, a subprocess, `np.asarray` on device values, thread\n"
                "`.join`) serializes every contending thread behind IO the lock was never\n"
                "meant to cover. Hot-path locks must only guard memory ops: move the IO\n"
                "outside the critical section (snapshot-then-write) or keep a dedicated\n"
                "coarse lock for the slow path and document it with a waiver."
            ),
        ),
        Rule(
            id="TMR-HANDLER",
            family="handler-safety",
            summary="signal/atexit/excepthook code blocking on a lock or mutating shared state",
            counter="race.handler",
            runtime_signal=(
                "a dump-on-preemption that deadlocks: the signal arrives while the "
                "preempted thread holds the lock the handler then blocks on — the process "
                "dies silently with NO flight dump"
            ),
            rationale=(
                "Signal handlers run ON TOP of a preempted thread; atexit/excepthook run\n"
                "while daemon threads may be mid-critical-section. Any blocking\n"
                "`lock.acquire()` (including `with lock:`) reachable from handler\n"
                "context can therefore wait on a holder that will never resume.\n"
                "Handler paths must use try-lock (`acquire(blocking=False)`) with a\n"
                "lock-free fallback (obs/flight.py), and must not perform non-atomic\n"
                "mutations of state other threads read."
            ),
        ),
        Rule(
            id="TMR-LEAK",
            family="lock-discipline",
            summary="thread spawned without a daemon flag or join/close path",
            counter="race.leaks",
            runtime_signal=(
                "process refuses to exit (non-daemon thread still parked in wait) or "
                "threads accumulate across restarts — a hanging test run or a climbing "
                "thread count"
            ),
            rationale=(
                "Every `threading.Thread(...)` the library starts must either be a\n"
                "daemon (`daemon=True`) or have an owned join/close path (the handle is\n"
                "stored and `.join()`ed by a close()/stop() method). A spawn with\n"
                "neither leaks: it pins the interpreter at exit and accumulates under\n"
                "restart churn."
            ),
        ),
    )
}

#: Rules that need the introspection pass (live instances built on a device).
INTROSPECTION_RULES: Tuple[str, ...] = ("TM-STATE-UNREG", "TM-REDUCE-MISMATCH", "TM-PERSIST")

#: the card tier's rules (``metrics_tpu_torch.analysis.san``): the crosscheck only
SAN_RULES: Tuple[str, ...] = ("TMS-LINTGAP", "TMS-STALE-WAIVER")

#: tmrace (concurrency tier) rules — produced by ``metrics_tpu_torch.analysis.race``.
RACE_RULES: Tuple[str, ...] = (
    "TMR-UNLOCKED", "TMR-ORDER", "TMR-HOLD-HOST", "TMR-HANDLER", "TMR-LEAK",
)

#: AST/introspection (tmlint) rules — everything not owned by another tier.
LINT_RULES: Tuple[str, ...] = tuple(r for r in RULES if r not in SAN_RULES and r not in RACE_RULES)


@dataclass
class Finding:
    """One finding, anchored to a repo-relative path and symbol.

    Baseline waivers match on ``(rule, path, symbol)`` — deliberately not the
    line number, so waived findings do not churn when unrelated edits shift
    lines in the file.
    """

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    symbol: str  # dotted context: "func", "Class.update", "Class.state_name"
    message: str
    waived: bool = False
    waive_reason: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def format(self) -> str:
        mark = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} [{self.symbol}] {self.message}{mark}"


def explain(rule_id: str) -> str:
    """Human ``--explain`` text for one rule (raises KeyError on unknown ids)."""
    r = RULES[rule_id]
    counter = r.counter if r.counter else "none — shows as lost state, not a count"
    return (
        f"{r.id} ({r.family}): {r.summary}\n"
        f"\nobs counter: {counter}"
        f"\nruntime signal: {r.runtime_signal}\n"
        f"\n{r.rationale}\n"
        "\nWaiving: add {\"rule\": \"" + r.id + "\", \"path\": \"<repo-relative file>\","
        " \"symbol\": \"<symbol>\", \"reason\": \"<why this is safe>\"} to"
        " metrics_tpu_torch/analysis/tmlint_baseline.json (see"
        " `python -m metrics_tpu_torch.analysis --help`)."
    )
