"""tmlint rule metadata and the Finding record (counterpart of
``metrics_tpu/analysis/findings.py``).

The port's rule table covers the families the port analyses: the AST and
introspection rules (TM-*), the concurrency rules (TMR-*), tmsan's rules (TMS-*: the
abstract tier's, read from traces on fake tensors; its cost budget; and the two
crosscheck rules, TMS-LINTGAP and TMS-STALE-WAIVER) and tmown's buffer-ownership
rules (TMO-*). Rule IDs, the ``Finding`` fields and its waiver key are the
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
            id="TMS-CALLBACK",
            family="jaxpr-trace",
            summary="host read in a traced update or compute",
            counter="san.callbacks",
            runtime_signal=(
                _CAPTURE_FAILS
                + "eagerly each step waits for the card and copies to the host: a gap between "
                "`tm.update/<M>` ranges in a profiler trace (obs/scopes.py)"
            ),
            rationale=(
                "tmlint's TM-HOSTSYNC works on source text; a host read can still reach a\n"
                "traced step through a waiver, a modeling gap or a helper it cannot see. The\n"
                "abstract tier looks at what runs: every budgeted class's `local_update` and\n"
                "`compute_from` traced on fake tensors (`FakeTensorMode`, nothing executes)\n"
                "inside `tracing()`. An `aten._local_scalar_dense` (`.item()`, `float()`,\n"
                "`bool()`), a `DataDependentOutputException` or a copy from the card to the\n"
                "host there means host code runs on every step of the hot path. Move the work\n"
                "onto the card, or declare the class `_host_side_update`."
            ),
        ),
        Rule(
            id="TMS-F64",
            family="jaxpr-trace",
            summary="float64 value in a trace whose inputs and states hold none",
            counter="san.f64",
            runtime_signal=(
                "on the card: 2x the bytes for the affected tensors and float64 arithmetic at "
                "1/2 (FMA) to 1/30 (no tensor cores) of the float32 rate; state_report() shows "
                "float64 buffers"
            ),
            rationale=(
                "Torch has no x64 switch: a float64 tensor appears where code asks for one\n"
                "(`dtype=torch.float64`, `.double()`, a numpy float64 array made into a\n"
                "tensor). In a trace whose inputs and states are all float32 or narrower, a\n"
                "float64 op is a silent widening that doubles bytes and falls off the fast\n"
                "path. The port's deliberate float64 sites (ROADMAP, deliberate deviations)\n"
                "are waived one by one with their reason."
            ),
        ),
        Rule(
            id="TMS-UPCAST",
            family="jaxpr-trace",
            summary="bf16/f16 state silently promoted to a wider dtype by update",
            counter="san.upcasts",
            runtime_signal=(
                "state_report() shows float32 buffers where bfloat16 was declared (2x the "
                "bytes); a checkpoint saved after the first update fails restore validation "
                "against the declared default dtype (ckpt DtypeDriftError); a captured step "
                "refuses the state (`CapturedStep`: a new state of another dtype)"
            ),
            rationale=(
                "A metric whose states are bfloat16 (`set_dtype(torch.bfloat16)`) must keep\n"
                "them bfloat16 through update: the state transition's output dtype is part of\n"
                "the Metric contract (ckpt manifests validate it; a captured step's static\n"
                "buffers hold it). A float32 tensor constant in the accumulation promotes the\n"
                "whole state. Use Python scalars or `.to(state.dtype)` so the declared dtype\n"
                "survives. (Deliberate float32 accumulation is fine: declare the STATE float32.)"
            ),
        ),
        Rule(
            id="TMS-BIGCONST",
            family="jaxpr-trace",
            summary="large tensor made from host data inside a traced update or compute",
            counter="san.bigconsts",
            runtime_signal=(
                "a host-to-device copy of the table at every eager step; in a captured step "
                "the table is baked into the graph's memory pool, per captured key "
                "(`fused.cache_misses` keys each hold a copy)"
            ),
            rationale=(
                "A tensor of 64 KiB or more made from host data inside the trace (a numpy\n"
                "table through `torch.tensor`/`from_numpy`, which the trace sees as\n"
                "`lift_fresh` or a host-to-device `_to_copy`/`copy_`) is copied to the card\n"
                "on every eager step and baked into every captured graph. Build it once on\n"
                "the card (cached per device), pass it as an input, or compute it on the card\n"
                "from cheap ops (`arange`)."
            ),
        ),
        Rule(
            id="TMS-COLLECTIVE",
            family="jaxpr-trace",
            summary="collective reached from an update or compute outside Metric.sync",
            counter="san.collectives",
            runtime_signal=(
                "a hang when one rank reaches a collective the others do not (an update "
                "called on some ranks only), or a capture that fails on an NCCL call"
            ),
            rationale=(
                "A `torch.distributed` collective (or a `c10d`/`_c10d_functional` op) reached\n"
                "from `local_update` or `compute_from` runs on whichever ranks happen to call\n"
                "the update: the classic SPMD deadlock. Collectives belong in `Metric.sync`\n"
                "and `sync_state` (utils/distributed.py, parallel/collective.py), where every\n"
                "rank enters them together."
            ),
        ),
        Rule(
            id="TMS-DYNSHAPE",
            family="jaxpr-trace",
            summary="metric body failed to trace (dynamic shape / data-dependent size)",
            counter="san.trace_failures",
            runtime_signal=(
                _CAPTURE_FAILS
                + "under `torch.func.vmap` the op has no batching rule for a dynamic shape"
            ),
            rationale=(
                "The abstract tier traces every budgeted class's update and compute on fake\n"
                "tensors: what a capture or a `torch.func` transform meets. An op whose output\n"
                "size depends on values (`DynamicOutputShapeException`: `nonzero`, boolean\n"
                "masks, `unique`) fails there: ground truth that the body is not trace-safe,\n"
                "and a finding tmlint's AST tier should have predicted (TM-DYNSHAPE). Fix\n"
                "the metric (static-shape ops, `torch.where`, `output_size=`) or declare it\n"
                "`_host_side_update` if it is host code by contract."
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
            id="TMO-DONATE-ALIAS",
            family="buffer-ownership",
            summary="possibly-host-aliasing tensor written in place by a step or accumulation",
            counter="own.donate_alias",
            runtime_signal=(
                "host memory that the program does not own written through: a checkpoint "
                "payload (a `bytes` object, immutable to Python) changes under its reader, or "
                "a numpy array the caller still holds changes at the next replay"
            ),
            rationale=(
                "`torch.from_numpy`, `torch.as_tensor`/`asarray` of host data on the CPU,\n"
                "`torch.frombuffer`, `np.frombuffer` and `memoryview` give a tensor that\n"
                "ALIASES memory the program does not own (the PR 16 restore shape: a\n"
                "checkpoint payload view). A captured step's replay (`CapturedStep`,\n"
                "`compile_step`: its states become the static buffers that the next replay\n"
                "overwrites) or an in-place accumulation (`add_`, `copy_`, `index_add_`,\n"
                "`out=`) on such a tensor writes through the alias. Take an owning copy\n"
                "first: `.clone()` (ckpt/restore.py's restore)."
            ),
        ),
        Rule(
            id="TMO-USE-AFTER-DONATE",
            family="buffer-ownership",
            summary="a step's state buffer read after a later replay, with no clone between",
            counter="own.use_after_donate",
            runtime_signal=(
                "a stale or torn read: the tensor taken before the replay now holds the "
                "replay's new state (`core/fused.py:is_step_buffer` says it is the step's "
                "static buffer), so a value meant as 'before' reads as 'after'"
            ),
            rationale=(
                "A captured step writes its new states into its static state buffers in place\n"
                "at every replay, and the live state IS that buffer after a replay. A name\n"
                "bound to the states before a replay reads the replay's result after it: the\n"
                "torch twin of reading a donated array. Re-point the name at the replay's\n"
                "returned states, or take a `.clone()` before the replay. Except handlers that\n"
                "probe `is_step_buffer`/`is_deleted` are the sanctioned recovery idiom and\n"
                "exempt."
            ),
        ),
        Rule(
            id="TMO-DOUBLE-DONATE",
            family="buffer-ownership",
            summary="one tensor in two in-place positions of one step",
            counter="own.double_donate",
            runtime_signal=(
                "two state leaves sharing one static buffer: the replay writes it twice and "
                "whichever accumulation lands last wins, so one metric's state is lost"
            ),
            rationale=(
                "A captured step clones each state leaf into its own static buffer and copies\n"
                "the new values back in place. The same tensor at two state positions (the same\n"
                "name passed twice, or two leaves aliasing one tensor after state surgery) is\n"
                "written twice. Dedup the leaves first (a dedup guard dominating the call)."
            ),
        ),
        Rule(
            id="TMO-SNAPSHOT-GAP",
            family="buffer-ownership",
            summary="replay with a pending async snapshot and no secure_pending_snapshots",
            counter="own.snapshot_gap",
            runtime_signal=(
                "an async checkpoint that referenced the states before the replay serializes "
                "the replay's new values: `ckpt.saves` commits a step whose payload is not "
                "the state it names"
            ),
            rationale=(
                "Async checkpointing keeps tensor REFERENCES and copies them to the host later\n"
                "on its writer thread. A replay (or an in-place accumulation) overwrites those\n"
                "tensors, so every such call must first secure the in-flight snapshots that\n"
                "reference them: `ckpt.manager.secure_pending_snapshots`. A call with no\n"
                "dominating snapshot guard races the writer. Where the port has no such guard,\n"
                "the engine worksheet shows the component as absent."
            ),
        ),
        Rule(
            id="TMO-KEY-GAP",
            family="buffer-ownership",
            summary="step-cache key omits an input the captured step depends on",
            counter="own.key_gap",
            runtime_signal=(
                "a stale-cache hit: the engine replays a graph captured for another closed-over "
                "value or shape: wrong results with no error, or a capture's copy-in that "
                "refuses the shape"
            ),
            rationale=(
                "A `StepCache` (`self._steps.call(key, ...)`) is sound only when `key` covers\n"
                "everything the captured graph was specialized on: every Python value the\n"
                "capture bakes in (builder arguments, static specs, closed-over locals) and\n"
                "each extra's shape and dtype. A tensor extra's VALUES are copied into the\n"
                "static input buffers at each replay and are not a gap."
            ),
        ),
        Rule(
            id="TMO-ENGINE-DRIFT",
            family="engine-contract",
            summary="launch-engine contract diverges from the shared one",
            counter="own.engine_drift",
            runtime_signal=(
                "a hazard fixed in one engine recurs in another: a snapshot-before-replay "
                "guard added to fused but not ingest shows up as the same checkpoint fault in "
                "another code path"
            ),
            rationale=(
                "fused, fleet, ingest and the rank tiers each implement the same launch\n"
                "contract: static-buffer accumulation, duplicate-state dedup,\n"
                "snapshot-before-replay, the registered-default clone, the `StepCache`, its\n"
                "`broken` keys, and the excache record. tmown extracts each engine's\n"
                "implementation of every component and flags a component that two or more\n"
                "engines have and one lacks. The matrix is the worksheet\n"
                "`metrics_tpu_torch/analysis/tmown_engine_drift.json`."
            ),
        ),
        Rule(
            id="TMS-BUDGET",
            family="hlo-cost",
            summary="traced cost grew >15% over the checked-in budget",
            counter="san.budget_breaches",
            runtime_signal=(
                "the next benchmark run regresses; tmsan catches it from the fake trace's "
                "counted flops, bytes and peak memory before any benchmark runs"
            ),
            rationale=(
                "`metrics_tpu_torch/analysis/san_costs.json` records flops\n"
                "(`torch.utils.flop_counter`), bytes accessed (each dispatched op's inputs and\n"
                "outputs) and peak bytes (the most fake storage alive at once) per (class,\n"
                "canonical shape), written on the card. A >15% unexplained growth is a perf\n"
                "regression (an accidental broadcast, a lost in-place op, a dtype widening).\n"
                "If the growth is intended, refresh the budget on the card:\n"
                "`python -m metrics_tpu_torch.analysis --san --write-costs`. This budget is\n"
                "not obs/launch_budget.json, which counts real kernel launches on the card."
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

#: tmsan rules (``metrics_tpu_torch.analysis.san``: the abstract tier, its cost budget and
#: the card's crosscheck). Baseline waivers are shared but scoped: each tier applies (and
#: reports staleness for) only the waivers in its own namespace.
SAN_RULES: Tuple[str, ...] = (
    "TMS-CALLBACK", "TMS-F64", "TMS-UPCAST", "TMS-BIGCONST",
    "TMS-COLLECTIVE", "TMS-DYNSHAPE", "TMS-LINTGAP", "TMS-STALE-WAIVER",
    "TMS-BUDGET",
)

#: tmrace (concurrency tier) rules — produced by ``metrics_tpu_torch.analysis.race``.
RACE_RULES: Tuple[str, ...] = (
    "TMR-UNLOCKED", "TMR-ORDER", "TMR-HOLD-HOST", "TMR-HANDLER", "TMR-LEAK",
)

#: tmown (buffer-ownership tier) rules — produced by ``metrics_tpu_torch.analysis.own``.
OWN_RULES: Tuple[str, ...] = (
    "TMO-DONATE-ALIAS", "TMO-USE-AFTER-DONATE", "TMO-DOUBLE-DONATE",
    "TMO-SNAPSHOT-GAP", "TMO-KEY-GAP", "TMO-ENGINE-DRIFT",
)

#: AST/introspection (tmlint) rules — everything not owned by another tier.
LINT_RULES: Tuple[str, ...] = tuple(
    r for r in RULES if r not in SAN_RULES and r not in RACE_RULES and r not in OWN_RULES
)


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
