#!/usr/bin/env python3
"""Smoke run of metrics_tpu_torch on one NVIDIA GPU: build, kernel checks, main path, timings.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1.
2. build: compiles every hand-written kernel from ``metrics_tpu_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, started together).
3. kernel_vs_plain: the histogram kernel against its plain PyTorch version on the
   card, bins {1, 25, 361, 2048, 16384} x N {1, 1000, 2^24+17}, ids in
   [-3, bins+3) so that drops happen; count and bool-mask results bit-equal,
   float32-weighted within 1e-5 of each bin's sum of |w| (atomics add in no fixed
   order), against a float64 run of the plain version.
4. main_path: per-pixel Cityscapes evaluation (19 train classes, 1024x2048 images,
   ignore label 255, batch 8: N = 2^24 predictions per update) through
   MulticlassAccuracy / MulticlassF1Score (macro), MulticlassJaccardIndex and
   MulticlassConfusionMatrix, three updates of logits drawn on the card from a
   seeded generator with about 5% of targets set to 255; then the README example
   (micro accuracy, 5 classes) and the 128-class macro accuracy on (1024, 128)
   logits. The confusion matrix must equal, bit for bit, the plain histogram
   called directly on the card; the float metrics must lie within 1e-6 of a CPU
   run of the port on the same tensors; the kernel's launch count must have grown
   by one per confusion-path update (4 per Cityscapes update).
5. timing: CUDA-event medians of each metric's update, and of the kernel, its plain
   version and ``torch.bincount`` (the yardstick, never called by the port) on the
   Cityscapes mask-path inputs, beside the kernel's bound.

The last three lines are the ``nvidia-smi`` name and power limit, the kernels JSON
line and ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
CITYSCAPES = {"classes": 19, "batch": 8, "height": 1024, "width": 2048, "ignore_index": 255}
UPDATES = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from metrics_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": [p.name for p in paths]})


def phase_kernel_vs_plain(torch, seed: int) -> None:
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst_rel = 0.0
    checked = 0
    for bins in (1, 25, 361, 2048, 16384):
        for n in (1, 1000, (1 << 24) + 17):
            ids = torch.randint(-3, bins + 3, (n,), generator=g, device="cuda", dtype=torch.int32)
            mask = torch.rand(n, generator=g, device="cuda") < 0.7
            w = torch.randn(n, generator=g, device="cuda", dtype=torch.float32)
            for name, weights in (("count", None), ("mask", mask)):
                got = histogram_cuda(ids, weights, bins)
                want = _plain_bincount(ids, weights, bins)
                if got.dtype != torch.int32 or not torch.equal(got, want):
                    diff = (got.long() - want.long()).abs().max().item()
                    raise AssertionError(f"{name} kernel != plain at bins={bins} n={n} (max |diff| {diff})")
                checked += 1
            got = histogram_cuda(ids, w, bins).double()
            want = _plain_bincount(ids, w.double(), bins)
            scale = _plain_bincount(ids, w.abs().double(), bins)
            err = (got - want).abs()
            if not bool(torch.all(err <= 1e-5 * scale)):
                raise AssertionError(f"f32 kernel off at bins={bins} n={n}: max err {err.max().item()}")
            nz = scale > 0
            if bool(nz.any()):
                worst_rel = max(worst_rel, (err[nz] / scale[nz]).max().item())
            checked += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "comparisons": checked, "f32_worst_err_over_abs_sum": worst_rel,
          "f32_rtol": 1e-5})


def cityscapes_batch(torch, g):
    c = CITYSCAPES
    logits = torch.randn((c["batch"], c["classes"], c["height"], c["width"]), generator=g, device="cuda")
    target = torch.randint(0, c["classes"], (c["batch"], c["height"], c["width"]), generator=g, device="cuda")
    ignore = torch.rand(target.shape, generator=g, device="cuda") < 0.05
    return logits, target.masked_fill(ignore, c["ignore_index"])


def cityscapes_metrics(device):
    from metrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassJaccardIndex,
    )

    c, ii = CITYSCAPES["classes"], CITYSCAPES["ignore_index"]
    return {
        "MulticlassAccuracy(macro)": MulticlassAccuracy(c, average="macro", ignore_index=ii, device=device),
        "MulticlassF1Score(macro)": MulticlassF1Score(c, average="macro", ignore_index=ii, device=device),
        "MulticlassJaccardIndex": MulticlassJaccardIndex(c, ignore_index=ii, device=device),
        "MulticlassConfusionMatrix": MulticlassConfusionMatrix(c, ignore_index=ii, device=device),
    }


def plain_confmat(torch, logits, target):
    """The Cityscapes confusion matrix through the plain histogram, called directly."""
    from metrics_tpu_torch.ops.histogram import _plain_bincount

    c = CITYSCAPES["classes"]
    mapping = target.clamp(0, c - 1) * c + logits.argmax(1).clamp(0, c - 1)
    valid = target != CITYSCAPES["ignore_index"]
    return _plain_bincount(mapping.reshape(-1), valid.reshape(-1), c * c).reshape(c, c).long()


def phase_main_path(torch, seed: int):
    from metrics_tpu_torch.classification import Accuracy, MulticlassAccuracy
    from metrics_tpu_torch.ops.histogram import histogram_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    gpu, cpu = cityscapes_metrics("cuda"), cityscapes_metrics("cpu")
    c = CITYSCAPES["classes"]
    reference = torch.zeros((c, c), dtype=torch.int64, device="cuda")
    batches = [cityscapes_batch(torch, g) for _ in range(UPDATES)]
    torch.cuda.synchronize()

    # README example and the 128-class macro accuracy at (1024, 128)
    readme_batches = [
        (torch.randn((4096, 5), generator=g, device="cuda"), torch.randint(0, 5, (4096,), generator=g, device="cuda"))
        for _ in range(UPDATES)
    ]
    wide_batches = [
        (torch.randn((1024, 128), generator=g, device="cuda"),
         torch.randint(0, 128, (1024,), generator=g, device="cuda"))
        for _ in range(UPDATES)
    ]
    readme = Accuracy(task="multiclass", num_classes=5)
    wide = MulticlassAccuracy(num_classes=128, average="macro")

    histogram_cuda.launches = 0  # ---- main path starts
    t0 = time.perf_counter()
    for logits, target in batches:
        for metric in gpu.values():
            metric.update(logits, target)
    values = {name: metric.compute() for name, metric in gpu.items()}
    torch.cuda.synchronize()
    cityscapes_s = time.perf_counter() - t0
    cityscapes_launches = histogram_cuda.launches
    for preds, target in readme_batches:
        readme(preds, target)
    for preds, target in wide_batches:
        wide.update(preds, target)
    readme_value, wide_value = readme.compute(), wide.compute()
    torch.cuda.synchronize()
    launches = histogram_cuda.launches  # ---- main path ends

    expected = UPDATES * len(gpu)
    if cityscapes_launches != expected:
        raise AssertionError(f"Cityscapes path launched the histogram kernel {cityscapes_launches} times, not {expected}")
    if launches != expected + UPDATES:
        raise AssertionError(f"main path launched the histogram kernel {launches} times, not {expected + UPDATES}")

    # checks: plain histogram on the card, and a CPU run of the port on the same tensors
    for logits, target in batches:
        reference += plain_confmat(torch, logits, target)
        logits_cpu, target_cpu = logits.cpu(), target.cpu()
        for metric in cpu.values():
            metric.update(logits_cpu, target_cpu)
    cm = values["MulticlassConfusionMatrix"]
    if cm.dtype != torch.int64 or not torch.equal(cm, reference):
        raise AssertionError("confusion matrix differs from the plain histogram on the card")
    if not torch.equal(cm.cpu(), cpu["MulticlassConfusionMatrix"].compute()):
        raise AssertionError("confusion matrix differs from the CPU run")
    if int(cm.sum()) != int(sum((t != CITYSCAPES["ignore_index"]).sum() for _, t in batches)):
        raise AssertionError("confusion matrix does not count every valid pixel once")
    diffs = {}
    for name in ("MulticlassAccuracy(macro)", "MulticlassF1Score(macro)", "MulticlassJaccardIndex"):
        value = values[name]
        if value.shape != () or not bool(torch.isfinite(value)):
            raise AssertionError(f"{name}: expected a finite scalar, got {value}")
        diffs[name] = abs(value.item() - cpu[name].compute().item())
        if diffs[name] > 1e-6:
            raise AssertionError(f"{name}: {value.item()} on the card vs {cpu[name].compute().item()} on the CPU")

    readme_cpu = Accuracy(task="multiclass", num_classes=5, device="cpu")
    wide_cpu = MulticlassAccuracy(num_classes=128, average="macro", device="cpu")
    for (p, t), (pw, tw) in zip(readme_batches, wide_batches):
        readme_cpu.update(p.cpu(), t.cpu())
        wide_cpu.update(pw.cpu(), tw.cpu())
    for name, got, want in (("readme", readme_value, readme_cpu.compute()), ("wide", wide_value, wide_cpu.compute())):
        if abs(got.item() - want.item()) > 1e-6:
            raise AssertionError(f"{name} accuracy {got.item()} on the card vs {want.item()} on the CPU")

    emit({
        "phase": "main_path",
        "cityscapes": {"updates": UPDATES, "predictions_per_update": batches[0][1].numel(),
                       "values": {k: v.item() for k, v in values.items() if v.dim() == 0},
                       "confmat_sum": int(cm.sum()), "abs_diff_vs_cpu": diffs,
                       "histogram_launches": cityscapes_launches, "seconds_incl_validation": cityscapes_s},
        "readme_micro_accuracy": readme_value.item(),
        "macro_accuracy_128": wide_value.item(),
        "histogram_launches": launches,
    })
    return gpu, batches[-1], launches


def phase_timing(torch, gpu, batch, launches: int, smi: str):
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    logits, target = batch
    c = CITYSCAPES["classes"]
    update_ms = {}
    for name, metric in gpu.items():
        update_ms[name] = event_ms(torch, lambda: metric.update(logits, target), reps=10)

    # the kernel's inputs on the main path: int32 ids in [0, 361) and the valid mask
    ids = (target.clamp(0, c - 1) * c + logits.argmax(1).clamp(0, c - 1)).to(torch.int32).reshape(-1).contiguous()
    mask = (target != CITYSCAPES["ignore_index"]).reshape(-1).contiguous()
    mask_f = mask.float()
    n, bins = ids.numel(), c * c
    got = histogram_cuda(ids, mask, bins)
    want = _plain_bincount(ids, mask, bins)
    lib = torch.bincount(ids, weights=mask_f, minlength=bins)
    max_abs_err = (got.long() - want.long()).abs().max().item()
    if max_abs_err != 0 or not torch.equal(lib.round().long(), want.long()):
        raise AssertionError("kernel, plain version and torch.bincount disagree on the main-path inputs")
    kernel_ms = event_ms(torch, lambda: histogram_cuda(ids, mask, bins))
    plain_ms = event_ms(torch, lambda: _plain_bincount(ids, mask, bins))
    library_ms = event_ms(torch, lambda: torch.bincount(ids, weights=mask_f, minlength=bins))
    bytes_moved = n * ids.element_size() + n * mask.element_size() + bins * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    emit({"phase": "timing", "card": smi, "update_ms_median": update_ms,
          "histogram": {"n": n, "bins": bins, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                        "torch_bincount_ms": library_ms, "bound_ms": bound_ms,
                        "kernel_share_of_bound": bound_ms / kernel_ms}})
    return [{
        "name": "histogram",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/histogram.cu",
        "replaces": "metrics_tpu/ops/histogram.py:87",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch  # noqa: F401  (fails, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    phase_build()
    phase_kernel_vs_plain(torch, args.seed)
    gpu, batch, launches = phase_main_path(torch, args.seed)
    kernels = phase_timing(torch, gpu, batch, launches, smi)

    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
