#!/usr/bin/env python3
"""Where the time of one retrieval compute goes on the MS MARCO evaluation path, on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 scripts/torch_retrieval_profile.py [--seed 0] [--reps 3]

Fills the five retrieval metrics of ``chip_smoke.py`` (RetrievalMRR, RetrievalMAP,
RetrievalNormalizedDCG(top_k=10), RetrievalPrecision(top_k=10), RetrievalRPrecision)
with its MS MARCO dev data (6,980 queries x 1,000 candidates in 70 updates), with list
states and with ``cat_capacity=2**23``, and prints one JSON line per metric and state
kind:

- ``compute_ms``: CUDA-event median of one ``compute`` (the cached value cleared);
- ``device_busy_ms``: device time of one compute, summed over its kernels and copies
  from a ``torch.profiler`` trace, and ``idle_share`` = 1 - busy / compute;
- ``scan_launches``: segmented-scan kernel launches per compute;
- ``groups``: device ms per compute by kind: the state concatenation, the sort, the
  gathers, the segmented-scan kernel (``csrc/segment_scan.cu``), the library scans
  (cumsum, cummax of the float running sums), memsets, and the rest;
- ``top``: the kernels that take the most device time.

A last line names the card and its power limit. Fails where there is no CUDA card.
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
    ("memset", ("Memset",)),
    ("sort", ("RadixSort", "radix_sort", "sort_kernel", "SortKernel", "segmented_sort", "bitonic")),
    ("state_concat", ("CatArrayBatchedCopy",)),
    ("gather", ("index_elementwise", "indexSelect", "gather", "index_select", "vectorized_gather")),
    ("library_scan", ("DeviceScan", "tensor_kernel_scan", "scan_", "cummax", "Scan")),
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
        print("torch_retrieval_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from metrics_tpu_torch import _build
    from metrics_tpu_torch.ops.segment import segment_scan_cuda

    _build.build()
    batches = chip_smoke.msmarco_batches(torch, args.seed)
    for kind, capacity in (("list", None), ("cat_capacity", chip_smoke.CAT_CAPACITY)):
        metrics = chip_smoke.retrieval_metrics(capacity)
        for preds, target, indexes in batches:
            for metric in metrics.values():
                metric.update(preds, target, indexes=indexes)
        for name, metric in metrics.items():
            def compute():
                metric._computed = None  # time the computation, not the cached value
                return metric.compute()

            value = compute().item()
            compute_ms = chip_smoke.event_ms(torch, compute, reps=5, warmup=1)
            before = segment_scan_cuda.launches
            torch.cuda.synchronize()
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(args.reps):
                    compute()
                torch.cuda.synchronize()
            launches = (segment_scan_cuda.launches - before) / args.reps
            per_compute = {k: v / args.reps / 1e3 for k, v in chip_smoke.device_events(prof).items()}
            groups = {}
            for key, ms in per_compute.items():
                groups[_group(key)] = groups.get(_group(key), 0.0) + ms
            busy = sum(per_compute.values())
            top = sorted(per_compute.items(), key=lambda kv: -kv[1])[:8]
            print(json.dumps({
                "metric": name, "states": kind, "value": value, "compute_ms": compute_ms,
                "device_busy_ms": busy, "idle_share": 1.0 - busy / compute_ms if busy else None,
                "scan_launches": launches, "groups": groups,
                "top": [{"name": k[:100], "ms": v} for k, v in top],
            }), flush=True)
        del metrics
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
