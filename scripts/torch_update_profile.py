#!/usr/bin/env python3
"""Where the time of one Cityscapes-sized metric update goes, on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 scripts/torch_update_profile.py [--seed 0] [--reps 5]

For each of the four metrics that ``chip_smoke.py`` drives on the Cityscapes shape
(19 classes, logits (8, 19, 1024, 2048), ignore label 255), it prints one JSON line:

- ``update_ms``: CUDA-event median of one ``update`` with ``validate_args`` on (the
  default) and off, so that the cost of the input checks shows;
- ``device_busy_ms``: the device time of one update, summed over its kernels and
  copies from a ``torch.profiler`` trace, and ``idle_share`` = 1 - busy / update;
- ``top``: the kernels and copies that take the most device time, per update.

A last line names the card and its power limit. Fails where there is no CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_update_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from metrics_tpu_torch import _build

    _build.build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    logits, target = chip_smoke.cityscapes_batch(torch, g)
    for name, metric in chip_smoke.cityscapes_metrics("cuda").items():
        update_ms = {}
        for validate in (True, False):
            metric.validate_args = validate
            update_ms["validate" if validate else "no_validate"] = chip_smoke.event_ms(
                torch, lambda: metric.update(logits, target), reps=10
            )
        metric.validate_args = True
        torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(args.reps):
                metric.update(logits, target)
            torch.cuda.synchronize()
        per_update = {k: v / args.reps / 1e3 for k, v in chip_smoke.device_events(prof).items()}
        busy = sum(per_update.values())
        top = sorted(per_update.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "metric": name,
            "update_ms": update_ms,
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / update_ms["validate"] if busy else None,
            "top": [{"name": k[:120], "ms": v} for k, v in top],
        }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
