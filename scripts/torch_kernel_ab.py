#!/usr/bin/env python3
"""Two versions of the hand-written CUDA kernels, timed in turns on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    git archive <older commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py --parent build/parent [--seed 0] [--reps 30]

Builds ``metrics_tpu_torch/csrc/histogram.cu`` and ``segment_scan.cu`` of this
checkout and of the ``--parent`` tree into ``build/ab/`` (one ``nvcc`` each, all
started together) and calls each library's C function directly, on the inputs of
the port's main paths:

- histogram, mask mode, 361 bins, N = 2^24: the Cityscapes update's ids and mask
  (``chip_smoke.histogram_inputs``), and a spatially coherent input of the same
  shape (``chip_smoke.coherent_histogram_inputs``);
- segment scan, two int32 ``min`` lanes, one segment, reverse: the DLRM compute's
  lanes at N = 89,137,319 and one ImageNet class's lanes at N = 50,000; and one
  int32 ``sum`` lane at N = 89,137,319, forward, beside ``torch.cumsum``; and a
  plain copy of the two DLRM lanes, the same bytes read once and written once;
- the host time per call of this checkout's two wrappers, their C calls and
  ``torch.cumsum`` at N = 1,000, where the device work is negligible.

The two versions compute the same function with the same C signature; the older
histogram expects a zeroed output, so its call zeroes it first (as its wrapper
did). For each input, one JSON line: the CUDA-event median of one call for each
version in the turns parent, change, change, parent; the device time of each
version's kernels and memsets per call from a ``torch.profiler`` trace; and whether
the two versions' outputs are bit-equal. A last line names the card and its power
limit. Fails where there is no CUDA card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("histogram", "segment_scan")


def build(trees):
    """nvcc for every (tag, source) at once; returns {(tag, name): ctypes library}."""
    sys.path.insert(0, REPO)
    from metrics_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for tag, root in trees.items():
        for name in NAMES:
            lib = os.path.join(out_dir, f"{tag}_{name}.so")
            src = os.path.join(root, "metrics_tpu_torch", "csrc", f"{name}.cu")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
            jobs[(tag, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = _build.bind(ctypes.CDLL(lib), key[1])
    return libs


def histogram_call(torch, lib, ids, mask, bins, zero_first):
    out = torch.empty(bins, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if zero_first:
            out.zero_()
        if lib.tm_histogram(ids.data_ptr(), mask.data_ptr(), 1, ids.numel(), bins, out.data_ptr(), stream) != 0:
            raise RuntimeError("histogram launch failed")
    return run, [out]


def scan_call(torch, lib, lanes, ops, reverse):
    k, n = len(lanes), lanes[0].numel()
    outs = [torch.empty_like(v) for v in lanes]
    scratch = torch.empty(max(lib.tm_segment_scan_scratch_bytes(k, 0, n), 16), dtype=torch.uint8, device="cuda")
    ins = (ctypes.c_void_p * k)(*[v.data_ptr() for v in lanes])
    outp = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    codes = (ctypes.c_int * k)(*[{"sum": 0, "min": 1, "max": 2}[op] for op in ops])
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if lib.tm_segment_scan(k, ins, outp, codes, 0, None, n, int(reverse), scratch.data_ptr(), stream) != 0:
            raise RuntimeError("segment scan launch failed")
    return run, outs


def host_us(torch, fn, calls: int = 3000) -> float:
    """Host microseconds per ``fn()``: enqueue time, the device left to catch up after."""
    import time

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def compare(torch, chip_smoke, label, calls, reps, extra=None):
    """calls: {tag: (run, outs)}; times in turns parent, change, change, parent."""
    for run, _ in calls.values():
        run()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(calls["parent"][1], calls["change"][1]))
    turns = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        turns[tag].append(chip_smoke.event_ms(torch, calls[tag][0], reps=reps, warmup=10))
    line = {"input": label, "event_ms": turns, "outputs_bit_equal": equal,
            "device_ms_per_call": {tag: chip_smoke.device_ms(torch, run, 10) for tag, (run, _) in calls.items()}}
    line.update(extra or {})
    print(json.dumps(line), flush=True)
    if not equal:
        raise AssertionError(f"{label}: the two versions disagree")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="root of a checkout of the version to compare against")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    libs = build({"parent": os.path.abspath(args.parent), "change": REPO})
    tags = ("parent", "change")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    c = chip_smoke.CITYSCAPES["classes"]
    bins = c * c

    logits, target = chip_smoke.cityscapes_batch(torch, g)
    ids, mask = chip_smoke.histogram_inputs(torch, target, logits.argmax(1))
    del logits, target
    coherent = chip_smoke.coherent_histogram_inputs(torch, g)
    for label, (x, m) in (("histogram uniform", (ids, mask)), ("histogram coherent", coherent)):
        calls = {tag: histogram_call(torch, libs[(tag, "histogram")], x, m, bins, tag == "parent") for tag in tags}
        compare(torch, chip_smoke, label, calls, args.reps, {"n": x.numel(), "bins": bins})
    del ids, mask, coherent

    scores, labels = chip_smoke.dlrm_data(torch, args.seed)
    lanes, _ = chip_smoke.sorted_run_lanes(torch, scores, labels)
    del scores, labels
    ops = ("min", "min")
    calls = {tag: scan_call(torch, libs[(tag, "segment_scan")], lanes, ops, True) for tag in tags}
    compare(torch, chip_smoke, "segment scan DLRM", calls, args.reps, {"n": lanes[0].numel(), "lanes": 2})
    del calls
    calls = {tag: scan_call(torch, libs[(tag, "segment_scan")], lanes[:1], ("sum",), False) for tag in tags}
    cumsum = [chip_smoke.event_ms(torch, lambda: torch.cumsum(lanes[0], 0, dtype=torch.int32), reps=args.reps,
                                  warmup=10)]
    compare(torch, chip_smoke, "segment scan one sum lane", calls, args.reps, {"n": lanes[0].numel(), "lanes": 1})
    cumsum.append(chip_smoke.event_ms(torch, lambda: torch.cumsum(lanes[0], 0, dtype=torch.int32), reps=args.reps,
                                      warmup=10))
    print(json.dumps({"input": "torch.cumsum one sum lane", "event_ms": cumsum,
                      "device_ms_per_call": chip_smoke.device_ms(
                          torch, lambda: torch.cumsum(lanes[0], 0, dtype=torch.int32), 10)}), flush=True)
    # what the card reaches when it reads the lanes once and writes them once
    copies = [torch.empty_like(v) for v in lanes]
    copy = lambda: [d.copy_(v) for d, v in zip(copies, lanes)]  # noqa: E731
    print(json.dumps({"input": "copy of the two DLRM lanes", "n": lanes[0].numel(),
                      "event_ms": chip_smoke.event_ms(torch, copy, reps=args.reps, warmup=10),
                      "device_ms_per_call": chip_smoke.device_ms(torch, copy, 10)}), flush=True)
    del copies
    del calls, lanes

    m, classes = chip_smoke.IMAGENET["samples"], chip_smoke.IMAGENET["classes"]
    probs = torch.softmax(2.0 * torch.randn((m, classes), generator=g, device="cuda"), dim=1)
    truth = torch.randint(0, classes, (m,), generator=g, device="cuda")
    small, _ = chip_smoke.sorted_run_lanes(torch, probs[:, 0].contiguous(), (truth == 0).long())
    calls = {tag: scan_call(torch, libs[(tag, "segment_scan")], small, ops, True) for tag in tags}
    compare(torch, chip_smoke, "segment scan ImageNet class", calls, 5 * args.reps, {"n": m, "lanes": 2})

    # host time per call where the device work is negligible (N = 1,000): what each
    # wrapper adds before its launch, against the C call alone and torch.cumsum
    from metrics_tpu_torch.ops.histogram import histogram_cuda
    from metrics_tpu_torch.ops.segment import segment_scan_cuda

    x = torch.arange(1000, dtype=torch.int32, device="cuda")
    ones = torch.ones(1000, dtype=torch.bool, device="cuda")
    scan_c, _ = scan_call(torch, libs[("change", "segment_scan")], [x], ("sum",), False)
    hist_c, _ = histogram_call(torch, libs[("change", "histogram")], x, ones, bins, False)
    print(json.dumps({"input": "host time per call, N = 1,000", "host_us": {
        "segment_scan wrapper": host_us(torch, lambda: segment_scan_cuda([x], None, ("sum",), False)),
        "segment_scan C call": host_us(torch, scan_c),
        "torch.cumsum": host_us(torch, lambda: torch.cumsum(x, 0, dtype=torch.int32)),
        "histogram wrapper": host_us(torch, lambda: histogram_cuda(x, ones, bins)),
        "histogram C call": host_us(torch, hist_c),
    }}), flush=True)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
