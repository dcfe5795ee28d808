#!/usr/bin/env python3
"""Where the time of one exact BinaryAUROC.compute goes on the DLRM evaluation path, on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 scripts/torch_curve_profile.py [--seed 0] [--reps 3]

Fills a ``BinaryAUROC()`` with the ``chip_smoke.py`` DLRM data (89,137,319 bf16-rounded
click scores in 1,361 updates), then, for the rank tier (the card's default at this
size) and the sort tier, prints one JSON line; a third line is the rank tier on a
``BinaryAUROC(cat_capacity=2**27)`` filled with the same updates (one buffer per
state, nothing to concatenate):

- ``compute_ms``: CUDA-event median of one ``compute`` (the cached value cleared);
- ``device_busy_ms``: device time of one compute, summed over its kernels and copies
  from a ``torch.profiler`` trace, and ``idle_share`` = 1 - busy / compute;
- ``groups``: device ms per compute by kind: the state concatenation, the sort, the
  gathers, the segmented-scan kernel (``csrc/segment_scan.cu``), memsets (the
  scan's scratch zeroing among them), and the rest;
- ``top``: the kernels that take the most device time;
- ``host_top``: the host operations and runtime calls that take the most CPU time
  of one compute, under the profiler (which adds its own cost).

Then one line per scan direction with the scan kernel alone on the compute's own
lanes (two int32 ``min`` lanes, one global segment): its CUDA-event median and the
device time per call of each kernel and memset it enqueues (one kernel and one
memset). A last line names the card and its power limit. Fails where there is no
CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# substrings of kernel names, by group; the first group that matches takes the kernel
GROUPS = (
    ("segment_scan_kernel", ("segment_scan_kernel",)),
    ("memset", ("Memset",)),  # the scan's scratch zeroing, and any other memset of the compute
    ("sort", ("RadixSort", "radix_sort", "sort_kernel", "SortKernel", "segmented_sort", "bitonic")),
    ("state_concat", ("CatArrayBatchedCopy",)),
    ("gather", ("index_elementwise", "indexSelect", "gather", "index_select", "vectorized_gather")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "rest"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_curve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke
    from metrics_tpu_torch import _build
    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.ops import rank
    from metrics_tpu_torch.ops.segment import segment_scan_cuda

    _build.build()
    scores, target = chip_smoke.dlrm_data(torch, args.seed)
    metrics = {"list": BinaryAUROC(), "cat_capacity": BinaryAUROC(cat_capacity=1 << 27)}
    for preds, labels in chip_smoke.dlrm_batches(scores, target, scores.numel()):
        for m in metrics.values():
            m.update(preds, labels)

    for states, tier in (("list", "rank"), ("list", "sort"), ("cat_capacity", "rank")):
        metric = metrics[states]

        def compute():
            metric._computed = None  # time the computation, not the cached value
            return metric.compute()

        with rank.force_tier(tier):
            value = compute().item()
            compute_ms = chip_smoke.event_ms(torch, compute, reps=5, warmup=1)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(args.reps):
                    compute()
                torch.cuda.synchronize()
        per_compute = {k: v / args.reps / 1e3 for k, v in chip_smoke.device_events(prof).items()}
        groups = {}
        for name, ms in per_compute.items():
            groups[_group(name)] = groups.get(_group(name), 0.0) + ms
        busy = sum(per_compute.values())
        top = sorted(per_compute.items(), key=lambda kv: -kv[1])[:10]
        host = sorted(
            ((e.key, e.self_cpu_time_total / args.reps / 1e3) for e in prof.key_averages() if e.self_cpu_time_total > 0),
            key=lambda kv: -kv[1],
        )[:8]
        print(json.dumps({
            "tier": tier,
            "states": states,
            "n": scores.numel(),
            "auroc": value,
            "compute_ms": compute_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / compute_ms if busy else None,
            "groups": groups,
            "top": [{"name": k[:120], "ms": v} for k, v in top],
            "host_top": [{"name": k[:80], "self_cpu_ms": v} for k, v in host],
        }), flush=True)

    del metrics
    # the scan kernel alone on the compute's own lanes, by kernel and memset, in both directions
    lanes, _ = chip_smoke.sorted_run_lanes(torch, scores, target)
    for reverse in (True, False):
        ms = chip_smoke.event_ms(torch, lambda: segment_scan_cuda(lanes, None, ("min", "min"), reverse))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                segment_scan_cuda(lanes, None, ("min", "min"), reverse)
            torch.cuda.synchronize()
        by_kernel = {k[:60]: v / args.reps / 1e3 for k, v in chip_smoke.device_events(prof).items()}
        print(json.dumps({"scan_kernel": {"n": lanes[0].numel(), "lanes": 2, "reverse": reverse,
                                          "event_ms": ms, "device_ms_by_kernel": by_kernel}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
