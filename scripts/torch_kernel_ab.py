#!/usr/bin/env python3
"""Two versions of the hand-written CUDA kernels, timed in turns on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    git archive <older commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py --parent build/parent [--seed 0] [--reps 30]
        [--pairs 12] [--kernels histogram,segment_scan,greedy_match,kendall_pairs]

Builds ``metrics_tpu_torch/csrc/histogram.cu``, ``segment_scan.cu`` and
``greedy_match.cu`` (those ``--kernels`` names) of this checkout and of the
``--parent`` tree into ``build/ab/`` (one ``nvcc`` each, all started together) and
calls each library's C function directly, on the inputs of the port's main paths:

- histogram, mask mode, 361 bins, N = 2^24: the Cityscapes update's ids and mask
  (``chip_smoke.histogram_inputs``), and a spatially coherent input of the same
  shape (``chip_smoke.coherent_histogram_inputs``);
- segment scan, two int32 ``min`` lanes, one segment, reverse: the DLRM compute's
  lanes at N = 89,137,319 and one ImageNet class's lanes at N = 50,000; and one
  int32 ``sum`` lane at N = 89,137,319, forward, beside ``torch.cumsum``; and a
  plain copy of the two DLRM lanes, the same bytes read once and written once;
- the host time per call of this checkout's two wrappers, their C calls and
  ``torch.cumsum`` at N = 1,000, where the device work is negligible;
- greedy match (``tm_greedy_match``): the three launches of the COCO 2017 val
  detection computes of ``chip_smoke.phase_detection`` (5,000 images drawn on the
  card; the consolidated compute's small bucket 400000 x 16 x 16 and big bucket
  32 x 64 x 64, the list compute's 524288 x 64 x 64), recorded from one run of each
  compute; then this checkout's two variants forced (``tm_greedy_match_variant``:
  0 narrow, 1 warp) on those inputs and on ``chip_smoke.match_case`` inputs of
  N x 16 x G, G in {16, 32, 64}, N * 40 triples from 1,280 to 1,310,720: the sweep
  that sets the crossover ``narrow_min_triples`` in the source;
- Kendall's pair counts: the all-pairs kernel of a ``--parent`` tree that still holds
  it (``kendall_pairs.cu``, ``tm_kendall_pairs``, with the transposes its wrapper
  made; this checkout has only the chain) against this checkout's merge-count chain
  (``KendallPairsKernel._merge``: the key kernel, ``torch.sort``, the tile, merge,
  tie-run and finish kernels) on the Kendall inputs of
  ``chip_smoke.phase_regression_audio`` (N = 131,072 x 1, QM9's 10,831 x 12, STS-B's
  1,500 x 1); then, at STS-B's 1,500 x 1, QM9's first column (10,831 x 1) and random
  columns of 4,096 and 24,576 rows, ``--pairs`` pairs of turns that alternate which
  of the two runs first, each turn the CUDA-event median of ``--reps`` calls: each
  side's quartiles over its turns, and the pairs the all-pairs kernel wins.

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
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("histogram", "segment_scan", "greedy_match", "kendall_pairs")
#: the versions built from --parent only: this checkout's Kendall chain runs through its wrapper
PARENT_ONLY = ("kendall_pairs",)


def build(trees, names=NAMES):
    """nvcc for every (tag, source) at once; returns {(tag, name): ctypes library}."""
    sys.path.insert(0, REPO)
    from metrics_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for tag, root in trees.items():
        for name in names:
            if name in PARENT_ONLY and tag != "parent":
                continue
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


def coco_match_inputs(torch, chip_smoke, seed):
    """The greedy-match inputs of the COCO 2017 val computes: {label: args}."""
    from metrics_tpu_torch.ops import greedy_match as gm

    data = chip_smoke.coco_detection_data(torch, seed)
    recorder = chip_smoke.RecordingMatch(gm.greedy_match_cuda)
    kernel, gm.greedy_match_cuda = gm.greedy_match_cuda, recorder
    try:
        for layout in ("consolidated", "list"):
            chip_smoke.run_map(torch, data, 0, chip_smoke.COCO_DET["images"], layout)
    finally:
        gm.greedy_match_cuda = kernel
    labels = ("small bucket", "big bucket", "list layout")
    return {f"greedy match {name} " + "x".join(map(str, args[0].shape)): args
            for name, args in zip(labels, recorder.calls)}


def match_sweep(torch, chip_smoke, lib, coco, seed, reps):
    """Both variants of this checkout's kernel at each shape: the crossover."""
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    ranges = next(iter(coco.values()))[6]
    thresholds = next(iter(coco.values()))[5]
    cases = dict(coco)
    for width in (16, 32, 64):
        for n in (32, 128, 512, 1024, 2048, 4096, 8192, 32768):
            cases[f"match_case {n}x16x{width}"] = (*chip_smoke.match_case(torch, g, n, 16, width), thresholds, ranges)
    for label, args in cases.items():
        ms = {}
        for variant in (0, 1):
            run, _ = chip_smoke.match_call(torch, lib, args, variant)
            if run() != 0:
                raise RuntimeError(f"variant {variant} at {label}: greedy match launch failed")
            ms[variant] = chip_smoke.event_ms(torch, run, reps=reps, warmup=3)
        n, _, width = args[0].shape
        print(json.dumps({"input": f"variant sweep {label}", "triples": n * args[5].shape[0] * args[6].shape[0],
                          "g": width, "narrow_ms": ms[0], "warp_ms": ms[1]}), flush=True)


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
    """calls: {tag: (run, outs)}; times in turns parent, change, change, parent. A run
    that returns a value (the greedy match's CUDA error) fails on any but 0."""
    for tag, (run, _) in calls.items():
        if run():
            raise RuntimeError(f"{label}: the {tag} launch failed")
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
    parser.add_argument("--pairs", type=int, default=12, help="alternating pairs of turns of each Kendall cell")
    parser.add_argument("--kernels", default=",".join(NAMES), help="comma-separated names among " + ", ".join(NAMES))
    args = parser.parse_args()
    names = tuple(args.kernels.split(","))
    if not set(names) <= set(NAMES):
        parser.error(f"--kernels takes names among {NAMES}")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    libs = build({"parent": os.path.abspath(args.parent), "change": REPO}, names)
    tags = ("parent", "change")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    if "greedy_match" in names:
        coco = coco_match_inputs(torch, chip_smoke, args.seed)
        for label, match_args in coco.items():
            calls = {tag: chip_smoke.match_call(torch, libs[(tag, "greedy_match")], match_args) for tag in tags}
            compare(torch, chip_smoke, label, calls, args.reps)
            del calls
        match_sweep(torch, chip_smoke, libs[("change", "greedy_match")], coco, args.seed, args.reps)
        del coco
        torch.cuda.empty_cache()
    if "kendall_pairs" in names:
        kendall_ab(torch, chip_smoke, libs[("parent", "kendall_pairs")], args)
    if "histogram" in names:
        histogram_ab(torch, chip_smoke, libs, tags, g, args.reps)
    if "segment_scan" in names:
        scan_ab(torch, chip_smoke, libs, tags, g, args)
        if "histogram" in names:
            wrapper_host_times(torch, chip_smoke, libs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


def all_pairs_call(torch, lib, x, y):
    """The all-pairs route's call: the columns transposed to be contiguous, one ``tm_kendall_pairs`` launch."""
    n, c = x.shape
    out = torch.empty((c, 4), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        xt, yt = x.t().contiguous(), y.t().contiguous()
        return lib.tm_kendall_pairs(xt.data_ptr(), yt.data_ptr(), n, c, out.data_ptr(), stream)
    return run, [out]


def chain_call(torch, wrapper, x, y):
    """This checkout's merge-count chain, as its wrapper runs it: the columns as float32,
    the output allocated, one ``_merge``."""
    from metrics_tpu_torch.ops.kendall import _as_columns

    outs = [None]

    def run():
        a, b = _as_columns(x, y)
        outs[0] = torch.empty((a.shape[1], 4), dtype=torch.int64, device="cuda")
        wrapper._merge(a, b, outs[0])
    return run, outs


def quartiles(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"q1": q1, "median": q2, "q3": q3}


def kendall_ab(torch, chip_smoke, lib, args):
    from metrics_tpu_torch.ops.kendall import kendall_pairs_cuda

    n = chip_smoke.KENDALL_ALONE["rows"]
    g = torch.Generator(device="cuda").manual_seed(args.seed + 700)  # chip_smoke.ra_kendall_kernel's draw
    x = torch.randn(n, generator=g, device="cuda")
    y = x + torch.randn(n, generator=g, device="cuda")
    qm9 = chip_smoke.qm9_data(torch, args.seed)
    preds, gold = chip_smoke.stsb_data(torch, args.seed)
    inputs = {f"kendall alone {n}x1": (x[:, None], y[:, None]), "kendall QM9 10831x12": qm9,
              "kendall STS-B 1500x1": (preds[:, None], gold[:, None])}
    for label, (a, b) in inputs.items():
        calls = {"parent": all_pairs_call(torch, lib, a, b), "change": chain_call(torch, kendall_pairs_cuda, a, b)}
        compare(torch, chip_smoke, label, calls, args.reps, {"rows": a.shape[0], "columns": a.shape[1]})
    sweep = torch.Generator(device="cuda").manual_seed(args.seed + 701)
    cells = {"STS-B 1500x1": (preds[:, None], gold[:, None]), "QM9 column 0 10831x1": (qm9[0][:, :1], qm9[1][:, :1])}
    for rows in (4096, 24_576):
        a = torch.randn(rows, 1, generator=sweep, device="cuda")
        cells[f"random {rows}x1"] = (a, a + torch.randn(rows, 1, generator=sweep, device="cuda"))
    for label, (a, b) in cells.items():
        calls = {"all_pairs": all_pairs_call(torch, lib, a, b), "chain": chain_call(torch, kendall_pairs_cuda, a, b)}
        for run, _ in calls.values():
            if run():
                raise RuntimeError(f"kendall {label}: a launch failed")
        torch.cuda.synchronize()
        if not torch.equal(calls["all_pairs"][1][0], calls["chain"][1][0]):
            raise AssertionError(f"kendall {label}: the all-pairs kernel and the chain disagree")
        turns = {"all_pairs": [], "chain": []}
        for i in range(args.pairs):
            for tag in ("all_pairs", "chain") if i % 2 == 0 else ("chain", "all_pairs"):
                turns[tag].append(chip_smoke.event_ms(torch, calls[tag][0], reps=args.reps, warmup=3))
        wins = sum(p < c for p, c in zip(turns["all_pairs"], turns["chain"]))
        print(json.dumps({"input": f"kendall route pairs {label}", "rows": a.shape[0], "columns": a.shape[1],
                          "pairs": args.pairs, "all_pairs_wins": wins, "event_ms": turns,
                          "quartiles": {tag: quartiles(v) for tag, v in turns.items()},
                          "device_ms_per_call": {tag: chip_smoke.device_ms(torch, run, 10)
                                                 for tag, (run, _) in calls.items()}}), flush=True)


def histogram_ab(torch, chip_smoke, libs, tags, g, reps):
    c = chip_smoke.CITYSCAPES["classes"]
    bins = c * c
    logits, target = chip_smoke.cityscapes_batch(torch, g)
    ids, mask = chip_smoke.histogram_inputs(torch, target, logits.argmax(1))
    del logits, target
    coherent = chip_smoke.coherent_histogram_inputs(torch, g)
    for label, (x, m) in (("histogram uniform", (ids, mask)), ("histogram coherent", coherent)):
        calls = {tag: histogram_call(torch, libs[(tag, "histogram")], x, m, bins, tag == "parent") for tag in tags}
        compare(torch, chip_smoke, label, calls, reps, {"n": x.numel(), "bins": bins})


def scan_ab(torch, chip_smoke, libs, tags, g, args):
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
    del copies, calls, lanes

    m, classes = chip_smoke.IMAGENET["samples"], chip_smoke.IMAGENET["classes"]
    probs = torch.softmax(2.0 * torch.randn((m, classes), generator=g, device="cuda"), dim=1)
    truth = torch.randint(0, classes, (m,), generator=g, device="cuda")
    small, _ = chip_smoke.sorted_run_lanes(torch, probs[:, 0].contiguous(), (truth == 0).long())
    calls = {tag: scan_call(torch, libs[(tag, "segment_scan")], small, ops, True) for tag in tags}
    compare(torch, chip_smoke, "segment scan ImageNet class", calls, 5 * args.reps, {"n": m, "lanes": 2})


def wrapper_host_times(torch, chip_smoke, libs):
    """Host time per call where the device work is negligible (N = 1,000): what each
    wrapper adds before its launch, against the C call alone and torch.cumsum."""
    from metrics_tpu_torch.ops.histogram import histogram_cuda
    from metrics_tpu_torch.ops.segment import segment_scan_cuda

    bins = chip_smoke.CITYSCAPES["classes"] ** 2
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


if __name__ == "__main__":
    sys.exit(main())
