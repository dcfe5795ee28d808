"""Loop the ingest queue's caller-ticked reader check on the card, in one process.

The check is ``tests/test_torch_kernels.py::test_ingest_reader_on_another_stream_sees_every_tick_on_card[caller]``:
64 batches of 8,192 rows go through an :class:`~metrics_tpu_torch.serve.IngestQueue` over the
canonical fused collection while the caller enqueues on a side stream and calls ``tick(3)``
after every fifth batch, so that the tick thread and the caller each capture chained steps;
the flushed values must equal a synchronous run, with no degraded tick.

Each trial is one queue. Around every capture the script records what the process did:
the capture's error (a degraded tick), and each garbage collection that ran while a capture
was open, on the capturing thread or on another one. Conditions run before the loop:

- ``none``: the loop alone;
- ``failed_capture``: a capture invalidated by a host read, as the card tests force one;
- ``kernels_file``: the rest of ``tests/test_torch_kernels.py`` (``pytest.main``);
- ``analysis_card``: ``tests/test_torch_analysis_card.py`` (``pytest.main``).

Usage, from the root of a checkout on a machine with a card::

    python3 scripts/torch_ingest_capture_loop.py --trials 100 --before failed_capture
    python3 scripts/torch_ingest_capture_loop.py --tree build/parent --trials 100

``--tree`` imports ``metrics_tpu_torch`` from another checkout (unpack it with ``git archive``).
``--gc-threshold N`` sets the first generation's collection threshold (700 by default in
CPython), so that collections run more often. Prints one JSON line with the counts.

``--free-during-capture capturing_thread|other_thread`` runs the fault's mechanism instead
of the queue: each trial captures a step whose body, while its capture is open, frees
another captured step (its last reference dropped on the capturing thread, or on a
thread it starts and joins), and counts the captures that fail::

    python3 scripts/torch_ingest_capture_loop.py --free-during-capture other_thread --trials 20
"""
import argparse
import gc
import json
import os
import sys
import threading
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=50)
    parser.add_argument("--tree", default=".")
    parser.add_argument("--before", default="none", choices=("none", "failed_capture", "kernels_file",
                                                              "analysis_card"))
    parser.add_argument("--gc-threshold", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=0.0, help="stop starting trials after this many seconds")
    parser.add_argument("--free-during-capture", default="", choices=("", "capturing_thread", "other_thread"))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ingest_capture_loop: needs a CUDA card", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from metrics_tpu_torch.core import fused
    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection
    from metrics_tpu_torch.serve import IngestQueue

    if not fused.__file__.startswith(tree):
        raise RuntimeError(f"imported {fused.__file__}, not the tree {tree}")

    if args.before in ("kernels_file", "analysis_card"):
        import pytest

        target = {"kernels_file": "tests/test_torch_kernels.py",
                  "analysis_card": "tests/test_torch_analysis_card.py"}[args.before]
        extra = ["-k", "not reader_on_another_stream"] if args.before == "kernels_file" else []
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q", "-x", os.path.join(tree, target), *extra])
        print(json.dumps({"before": args.before, "pytest_rc": int(rc)}), flush=True)
    elif args.before == "failed_capture":
        def host_read(states, x):
            if float(x.sum()) > -1:
                return {"s": states["s"] + x}, None
            return states, None

        try:
            CapturedStep(host_read, {"s": torch.zeros(4, device="cuda")}, [torch.ones(4, device="cuda")],
                         torch.device("cuda"))
        except Exception:  # noqa: BLE001 - the failure is the point
            pass
    if args.gc_threshold:
        gc.set_threshold(args.gc_threshold, *gc.get_threshold()[1:])
    if args.free_during_capture:
        return _free_during_capture(torch, CapturedStep, args)

    capturing = {"thread": None}
    seen = {"captures": 0, "capture_errors": [], "gc_in_capture_same_thread": 0, "gc_in_capture_other_thread": 0,
            "other_threads_at_error": []}
    original = CapturedStep._capture

    def watched(self, *a, **kw):
        capturing["thread"] = threading.get_ident()
        seen["captures"] += 1
        try:
            return original(self, *a, **kw)
        except BaseException as err:
            frames = sys._current_frames()
            seen["capture_errors"].append(f"{type(err).__name__}: {str(err).splitlines()[0][:160] if str(err) else ''}")
            seen["other_threads_at_error"].append([
                f"{t.name}: " + " <- ".join(
                    f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}:{f.f_code.co_name}"
                    for f in _stack(frames.get(t.ident), 4))
                for t in threading.enumerate() if t.ident != threading.get_ident()])
            raise
        finally:
            capturing["thread"] = None

    def on_gc(phase, info):
        owner = capturing["thread"]
        if phase == "start" and owner is not None:
            key = "gc_in_capture_same_thread" if owner == threading.get_ident() else "gc_in_capture_other_thread"
            seen[key] += 1

    CapturedStep._capture = watched
    gc.callbacks.append(on_gc)

    g = torch.Generator(device="cuda").manual_seed(23)
    batches = [(torch.rand(8192, generator=g, device="cuda"),
                torch.randint(0, 2, (8192,), generator=g, device="cuda", dtype=torch.int32)) for _ in range(64)]
    sync = canonical_collection(True)
    for p, t in batches:
        sync.update(p, t)
    want = sync.compute()
    reader = torch.cuda.Stream()
    failures, degrades, mismatches, done = 0, 0, 0, 0
    t0 = time.perf_counter()
    for _trial in range(args.trials):
        if args.seconds and time.perf_counter() - t0 > args.seconds:
            break
        target = canonical_collection(True)
        with torch.cuda.stream(reader):
            with IngestQueue(target, capacity=16, tick_interval_s=0.0005, max_coalesce=8) as q:
                for i, (p, t) in enumerate(batches):
                    q.enqueue(p * 1.0, t + 0)
                    if i % 5 == 4:
                        q.tick(3)
                q.flush()
                got = target.compute()
                bad_ticks = q.stats["degrades"]
        torch.cuda.current_stream().wait_stream(reader)
        wrong = [k for k in want if not torch.equal(got[k], want[k])]
        degrades += bad_ticks
        mismatches += bool(wrong)
        failures += bool(bad_ticks or wrong)
        done += 1
    gc.callbacks.remove(on_gc)
    CapturedStep._capture = original
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({"tree": args.tree, "before": args.before, "gc_threshold": gc.get_threshold()[0],
                      "trials": done, "failed_trials": failures, "degraded_ticks": degrades,
                      "value_mismatches": mismatches, "seconds": time.perf_counter() - t0, "card": smi,
                      **{k: v for k, v in seen.items() if k not in ("capture_errors", "other_threads_at_error")},
                      "capture_errors": seen["capture_errors"][:5],
                      "other_threads_at_error": seen["other_threads_at_error"][:2]}), flush=True)
    return 0


def _free_during_capture(torch, CapturedStep, args) -> int:
    device = torch.device("cuda")
    x = torch.ones(16, device=device)
    failed, errors, done = 0, [], 0
    t0 = time.perf_counter()
    for _trial in range(args.trials):
        doomed = [CapturedStep(lambda s, e: ({"s": s["s"] + e}, None), {"s": torch.zeros(16, device=device)}, [x],
                               device)]

        def free():
            doomed.clear()  # the last reference: the step and its graph go here

        def step(states, extra):
            if torch.cuda.is_current_stream_capturing() and doomed:
                if args.free_during_capture == "capturing_thread":
                    free()
                else:
                    t = threading.Thread(target=free)
                    t.start()
                    t.join(timeout=30)
            return {"s": states["s"] * 2 + extra}, None

        try:
            captured = CapturedStep(step, {"s": torch.zeros(16, device=device)}, [x], device)
            new, _ = captured({"s": torch.zeros(16, device=device)}, [x])
            ok = torch.equal(new["s"], x)
        except Exception as err:  # noqa: BLE001 - a failed capture is what is counted
            ok = False
            errors.append(f"{type(err).__name__}: {str(err).splitlines()[0][:160] if str(err) else ''}")
        failed += not ok
        done += 1
    torch.cuda.synchronize()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({"tree": args.tree, "free_during_capture": args.free_during_capture, "trials": done,
                      "failed_captures": failed, "errors": sorted(set(errors))[:3],
                      "seconds": time.perf_counter() - t0, "card": smi}), flush=True)
    return 0


def _stack(frame, depth):
    out = []
    while frame is not None and len(out) < depth:
        out.append(frame)
        frame = frame.f_back
    return out


if __name__ == "__main__":
    sys.exit(main())
