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
   [-3, bins+3) so that drops happen; coherent runs of 1 to 4,096 equal ids (drops
   and masked rows inside runs); 13000 and then 16384 bins again after 16384 (both
   above 48 KB of shared memory); one hot bin at N = 2^24+17 (exact count); ids,
   masks and weights as views 1 to 3 elements in (not 16-byte aligned). Count and
   bool-mask results bit-equal, float32-weighted within 1e-5 of each bin's sum of
   |w| (atomics add in no fixed order), against a float64 run of the plain version.
4. segscan_kernel_vs_plain: the segmented multi-scan kernel against its plain
   version on the card, bit-equal, over k in {1, 2, 3, 4} lanes of mixed ops, int32
   and int64, flags None / random p=0.01 / every 1000th row / every row, forward and
   reverse, N in {1, 1000, 1024, 1025, 2^24+17, 89,137,319}; min/max lanes hold the
   type's extremes. Then the single-pass kernel's edges: N = T-1, T, T+1, 2T+1,
   3T+2, 3T+3 for each tile size T (ragged reverse tails with N % 4 of 1, 2, 3),
   lanes and flags as views 4 or 8 and 1 or 4 bytes in, and 20 launches in a row at
   N = 2^26+3 with four int64 lanes, flags none and every 1000th row.
5. main_path: per-pixel Cityscapes evaluation (19 train classes, 1024x2048 images,
   ignore label 255, batch 8: N = 2^24 predictions per update) through
   MulticlassAccuracy / MulticlassF1Score (macro), MulticlassJaccardIndex and
   MulticlassConfusionMatrix, three updates of logits drawn on the card from a
   seeded generator with about 5% of targets set to 255; then the README example
   (micro accuracy, 5 classes) and the 128-class macro accuracy on (1024, 128)
   logits. The confusion matrix must equal, bit for bit, the plain histogram
   called directly on the card; the float metrics must lie within 1e-6 of a CPU
   run of the port on the same tensors; the kernel's launch count must have grown
   by one per confusion-path update (4 per Cityscapes update).
6. curve_path: exact AUROC / average precision as MLPerf Training's DLRM benchmark
   evaluates a click model: the Criteo 1TB day-23 evaluation split, 89,137,319
   samples, in 1,361 updates of 65,536 rows (the last of 8,359), 3% positives,
   scores sigmoid(N(0,1)) for negatives and sigmoid(N(1.5,1)) for positives rounded
   through bfloat16, drawn on the card from a seeded generator, into BinaryAUROC(),
   BinaryAUROC(max_fpr=0.1) and BinaryAveragePrecision(): one scan-kernel launch
   per compute, 3 in all. Then ImageNet-1k validation: 50,000 x 1,000 softmax
   scores into MulticlassAUROC / MulticlassAveragePrecision(num_classes=1000): one
   launch per class, 2,000 in all. Checks: exact launch counts; on the same sorted
   inputs the kernel's (fps, tps) equal the plain version's bit for bit, and the
   sort and rank tiers agree bit for bit; AUROC within 1e-5 of a float64
   Mann-Whitney statistic with tie-averaged ranks, AP and the partial AUC within
   1e-5 of float64 sums over the run-end counts, all on the card; a CPU run of the
   port on the first 2^22 rows, and on the ImageNet scores, within 1e-6.
7. timing: CUDA-event medians of each metric's update (and the curve metrics'
   compute), and of each kernel, its plain version and a PyTorch yardstick never
   called by the port on the main paths' own inputs, beside each kernel's bound:
   the histogram on the Cityscapes update's ids and mask (``torch.bincount``), and
   on a spatially coherent input of the same shape (32x32-pixel patches of one
   class, predictions agreeing on 90% of pixels); the scan on the DLRM compute's
   two lanes, timed in turns (kernel, plain, ``torch.cummin`` on each pre-flipped
   lane, kernel) and reported from its second turn; the scan on one int32 sum lane
   of the same length in turns with ``torch.cumsum`` (CUB's single-pass scan: the
   library yardstick of the kernels line); the scan per call at the ImageNet
   shape (one class, 50,000 rows). Each kernel and yardstick is timed once per
   call with the device idle between calls (the host's time before the launch
   counts) and, where marked ``back_to_back``, per call over 20 calls queued
   together (the host's time overlaps the device's work).

8. retrieval_path: the MS MARCO passage-ranking dev evaluation, 6,980 queries x 1,000
   candidates = 6,980,000 rows drawn on the card (15% of queries without a relevant
   candidate, the rest with 1, 2 or 3; scores N(1.5, 1) for relevant rows, N(0, 1)
   for the others, rounded through bfloat16), in 70 updates of 100 queries (rows
   shuffled inside each update, query ids across updates) into RetrievalMRR(),
   RetrievalMAP(), RetrievalNormalizedDCG(top_k=10), RetrievalPrecision(top_k=10)
   and RetrievalRPrecision(), once with list states and once with
   ``cat_capacity=2**23``. Checks: the two runs bit-equal; each value within 1e-5
   of a float64 reference on the dense (6980, 1000) layout (a stable per-query sort,
   then closed forms); 8 scan launches per evaluation (1 MRR + 1 MAP + 1 NDCG + 2
   P@10 + 3 R-precision); every launch of one more evaluation bit-equal to the plain
   scan on the same lanes and flags. Timings: update and compute per metric, the
   kernel's event and device time on MRR's three lanes, pass A's two and a one-lane
   pass at this shape, the plain version, and ``torch.cumsum`` on one int32 lane.

9. collection: the Cityscapes evaluation (three new batches) through one
   MetricCollection of nine metrics: Accuracy, Precision, Recall, F1Score and
   Specificity (multiclass, macro), JaccardIndex, ConfusionMatrix, CohenKappa and
   MatthewsCorrCoef; beside it a MeanMetric of each batch's pixel accuracy and the
   composition 2PR/(P+R) of a macro precision and recall. Checks: the compute groups
   are the JAX package's two; the histogram kernel launches once per group and
   update (6), against 27 for the nine metrics updated apart; every value bit-equal
   to the metric run apart, the confusion matrix to the plain histogram, the
   composition to its formula on the apart values, the mean within 1e-6 of float64.
   Timing: the collection's update against the nine updates apart (CUDA events).
10. sync_nccl: an NCCL process group of one rank (``file://`` store under
    ``build/``); the collection, a samplewise MulticlassExactMatch (a cat state of
    bools) and RetrievalMAP over the MS MARCO rows, with list states and
    ``cat_capacity=2**23``, built with ``distributed_available_fn=lambda: True`` and
    the gather's collective body as ``dist_sync_fn``, so that every ``compute``
    runs ``all_gather`` on the card. Checks: synced values bit-equal to unsynced
    ones; the live states come back bit-equal after each synced compute, a
    ``CatBuffer`` still a ``CatBuffer``; a second ``sync()`` raises. Timing: one
    ``sync()`` per metric.
11. sync_ranks: four processes on the one card in a ``gloo`` group (CUDA tensors,
    which gloo stages through the host), spawned after the build; each rank feeds
    its own two Cityscapes batches to the collection and its share of the MS MARCO
    updates (14, 17, 22 and 17 of the 70) to RetrievalMAP with list and
    ``cat_capacity`` states, and syncs at ``compute``. Every rank's values must equal
    one process's run on the union in rank order (counts bit-equal, floats within
    1e-6), its list and ``cat_capacity`` values bit-equal; a rank that outlives the
    deadline is killed and the phase fails.

12. classification_rest: the rest of classification at published widths, data drawn on
    the card, one line per configuration (update and compute ms, launches of both
    kernels, the largest error against the reference):
    - DLRM, Criteo 1TB day 23 (89,137,319 rows, 1,361 updates): BinaryCalibrationError
      (15 bins) l1 with ``cat_capacity=2**27`` and max with list states (3 histogram
      launches per compute: count, correct mask, float32 confidence sums), and
      BinaryRecallAtFixedPrecision(0.5), BinaryPrecisionAtFixedRecall(0.5),
      BinarySpecificityAtSensitivity(0.9) (one scan launch each). ECE and MCE within
      1e-5 of float64 bucketing on the float32 boundaries of ``jnp.linspace``; each fixed
      point within 1e-6 of the float64 curve's, its threshold a qualifying point of it.
      The histogram's f32 and mask modes on these inputs (16 bins) against the plain
      version, ``torch.bincount`` and the bound.
    - ImageNet-1k validation (50,000 x 1,000 softmax, 50 updates): the 15-bin ECE within
      1e-5 of float64, Crammer-Singer hinge within 1e-5, recall at precision 0.5 per class
      (1,000 scan launches) within 1e-6 of the float64 curves.
    - MS-COCO 2014 val as multilabel (40,504 x 80, ~2.9 labels per image, bf16 scores):
      coverage error, label-ranking AP and ranking loss within 1e-6 of float64 per-sample
      references, precision at recall 0.5 and specificity at sensitivity 0.5 per label
      (160 scan launches) within 1e-6 of the float64 curves.
    - FairFace validation (10,954 faces, 7 groups): BinaryFairness(task="all"), one
      count-mode histogram launch (28 bins) per update, counts bit-equal to the plain
      histogram; the count mode timed as above.
    - Cityscapes: Dice on one batch (the void label as an ignored 20th class, micro,
      ``mdmc_average="global"``), bit-equal to 2tp/(2tp+fp+fn) from the plain confusion
      histogram; peak memory of the update.

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
# MLPerf Training DLRM: exact ROC AUC over the Criteo 1TB day-23 evaluation split
DLRM = {"samples": 89_137_319, "batch": 65_536, "positive_rate": 0.03, "positive_shift": 1.5}
IMAGENET = {"samples": 50_000, "classes": 1_000, "batch": 1_000}
# MS MARCO passage ranking, dev evaluation: 6,980 queries x their top-1000 re-ranked
# candidates; about 15% of queries without a relevant candidate (BM25 recall@1000 is
# about 0.85), the rest with 1 (most), 2 or 3
MSMARCO = {"queries": 6_980, "depth": 1_000, "batch_queries": 100, "relevant_shift": 1.5,
           "relevant_count_cdf": (0.15, 0.83, 0.9575)}
CAT_CAPACITY = 1 << 23
CPU_CHECK_ROWS = 1 << 22
# the compute groups of the Cityscapes collection, as metrics_tpu forms them
COLLECTION_GROUPS = [
    ["MulticlassAccuracy", "MulticlassF1Score", "MulticlassPrecision", "MulticlassRecall", "MulticlassSpecificity"],
    ["MulticlassCohenKappa", "MulticlassConfusionMatrix", "MulticlassJaccardIndex", "MulticlassMatthewsCorrCoef"],
]
SYNC_RANKS = 4
RANK_BATCHES = 2  # Cityscapes batches per rank
MSMARCO_RANK_UPDATES = (14, 17, 22, 17)  # of the 70 updates: 20, 24, 31 and 24% of the rows
RANKS_DEADLINE_S = 420
SCAN_SIZES = (1, 1000, 1024, 1025, (1 << 24) + 17, DLRM["samples"])
SCAN_OPS = {1: ("min",), 2: ("min", "min"), 3: ("sum", "min", "max"), 4: ("max", "sum", "min", "sum")}


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


def back_to_back_ms(torch, fn, calls: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Median device time per call of ``fn`` over runs of ``calls`` back-to-back calls,
    from CUDA events around each run: the host's time per call overlaps the device's
    work, as it does for a caller that queues work ahead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def check_histogram(torch, ids, mask, w, bins: int, label: str) -> float:
    """Count and mask modes bit-equal to the plain version, f32 weights within 1e-5 of
    each bin's sum of |w|; returns the worst f32 error over that sum."""
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    for name, weights in (("count", None), ("mask", mask)):
        got = histogram_cuda(ids, weights, bins)
        want = _plain_bincount(ids, weights, bins)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item()
            raise AssertionError(f"{name} kernel != plain at {label} (max |diff| {diff})")
    got = histogram_cuda(ids, w, bins).double()
    want = _plain_bincount(ids, w.double(), bins)
    scale = _plain_bincount(ids, w.abs().double(), bins)
    err = (got - want).abs()
    if not bool(torch.all(err <= 1e-5 * scale)):
        raise AssertionError(f"f32 kernel off at {label}: max err {err.max().item()}")
    nz = scale > 0
    return (err[nz] / scale[nz]).max().item() if bool(nz.any()) else 0.0


def phase_kernel_vs_plain(torch, seed: int) -> None:
    from metrics_tpu_torch.ops.histogram import histogram_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst_rel = 0.0
    checked = 0
    cases = []
    for bins in (1, 25, 361, 2048, 16384):
        for n in (1, 1000, (1 << 24) + 17):
            ids = torch.randint(-3, bins + 3, (n,), generator=g, device="cuda", dtype=torch.int32)
            cases.append((f"bins={bins} n={n}", ids, bins, 0))
    # coherent runs of 1 to 4,096 equal ids, with drops and masked rows inside runs
    for bins in (1, 25, 361, 16384):
        lengths = torch.randint(1, 4097, (4000,), generator=g, device="cuda")
        values = torch.randint(-3, bins + 3, (4000,), generator=g, device="cuda", dtype=torch.int32)
        cases.append((f"coherent runs bins={bins}", torch.repeat_interleave(values, lengths), bins, 0))
    # after 16384 bins, a smaller count that still needs more than 48 KB, then 16384 again
    for bins in (13000, 16384):
        ids = torch.randint(-3, bins + 3, ((1 << 20) + 3,), generator=g, device="cuda", dtype=torch.int32)
        cases.append((f"bins={bins} in turn", ids, bins, 0))
    # one hot bin, where the exact count must come out
    hot = torch.full(((1 << 24) + 17,), 5, dtype=torch.int32, device="cuda")
    cases.append(("one hot bin", hot, 25, 0))
    # ids, masks and weights as views 1 to 3 elements in: not 16-byte aligned
    for offset in (1, 2, 3):
        ids = torch.randint(-3, 364, ((1 << 20) + 5 + offset,), generator=g, device="cuda", dtype=torch.int32)
        cases.append((f"views at offset {offset}", ids, 361, offset))
    for label, ids, bins, offset in cases:
        n = ids.numel()
        mask = torch.rand(n, generator=g, device="cuda") < (0.9 if "coherent" in label else 0.7)
        w = torch.randn(n, generator=g, device="cuda", dtype=torch.float32)
        if offset:
            ids, mask, w = ids[offset:], mask[offset:], w[offset:]
        worst_rel = max(worst_rel, check_histogram(torch, ids, mask, w, bins, label))
        checked += 3
    if int(histogram_cuda(hot, None, 25)[5]) != hot.numel():
        raise AssertionError("the hot bin's count is not exact")
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "comparisons": checked, "f32_worst_err_over_abs_sum": worst_rel,
          "f32_rtol": 1e-5})


def cityscapes_batch(torch, g):
    c = CITYSCAPES
    logits = torch.randn((c["batch"], c["classes"], c["height"], c["width"]), generator=g, device="cuda")
    target = torch.randint(0, c["classes"], (c["batch"], c["height"], c["width"]), generator=g, device="cuda")
    ignore = torch.rand(target.shape, generator=g, device="cuda") < 0.05
    return logits, target.masked_fill(ignore, c["ignore_index"])


def histogram_inputs(torch, target, pred):
    """The confusion path's kernel inputs: int32 ids t * C + p in [0, C^2) and the valid mask."""
    c = CITYSCAPES["classes"]
    ids = (target.clamp(0, c - 1) * c + pred.clamp(0, c - 1)).to(torch.int32).reshape(-1).contiguous()
    return ids, (target != CITYSCAPES["ignore_index"]).reshape(-1).contiguous()


def coherent_histogram_inputs(torch, g):
    """Spatially coherent Cityscapes-shaped kernel inputs: targets in 32x32-pixel patches
    of one class (5% of patches at the ignore label), predictions equal to the target
    on 90% of the pixels and uniform on the rest."""
    c, p = CITYSCAPES, 32
    patches = torch.randint(0, c["classes"], (c["batch"], c["height"] // p, c["width"] // p), generator=g,
                            device="cuda")
    ignore = torch.rand(patches.shape, generator=g, device="cuda") < 0.05
    target = patches.masked_fill(ignore, c["ignore_index"]).repeat_interleave(p, 1).repeat_interleave(p, 2)
    other = torch.randint(0, c["classes"], target.shape, generator=g, device="cuda")
    agree = torch.rand(target.shape, generator=g, device="cuda") < 0.9
    return histogram_inputs(torch, target, torch.where(agree, target, other))


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


def scan_flags(torch, kind: str, n: int, g):
    if kind == "none":
        return None
    if kind == "p01":
        return torch.rand(n, generator=g, device="cuda") < 0.01
    if kind == "every1000":
        return torch.arange(n, device="cuda") % 1000 == 0
    return torch.ones(n, dtype=torch.bool, device="cuda")


def scan_lanes(torch, n: int, dtype, ops, g):
    """Random lanes; min/max lanes carry the type's extremes (their identities) at 5% each."""
    info = torch.iinfo(dtype)
    lanes = []
    for op in ops:
        v = torch.randint(-1000, 1000, (n,), generator=g, device="cuda", dtype=dtype)
        if op != "sum":
            pick = torch.rand(n, generator=g, device="cuda")
            v = torch.where(pick < 0.05, info.max, torch.where(pick > 0.95, info.min, v)).to(dtype)
        lanes.append(v)
    return lanes


def compare_scan(torch, lanes, flags, ops, reverse: bool, label: str) -> None:
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    got = segment_scan_cuda(lanes, flags, ops, reverse)
    want = _plain_multi_scan(lanes, flags, ops, reverse)
    for lane, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"segment scan kernel != plain at {label} lane={lane} ops={ops} reverse={reverse}:"
                                 f" {int((a != b).sum())} rows differ")


def phase_segscan_kernel_vs_plain(torch, seed: int) -> None:
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    checked = 0
    for n in SCAN_SIZES:
        for dtype in (torch.int32, torch.int64):
            for k, ops in SCAN_OPS.items():
                lanes = scan_lanes(torch, n, dtype, ops, g)
                for kind in ("none", "p01", "every1000", "all"):
                    flags = scan_flags(torch, kind, n, g)
                    for reverse in (False, True):
                        compare_scan(torch, lanes, flags, ops, reverse, f"n={n} {dtype} k={k} flags={kind}")
                        checked += 1
                del lanes
    # the single-pass kernel's edges: N = T-1, T, T+1, 2T+1 for each tile size T, and
    # ragged reverse tails with n % 4 of 1, 2 and 3
    edges = 0
    for dtype in (torch.int32, torch.int64):
        for k, ops in SCAN_OPS.items():
            tile = segment_scan_cuda.tile_rows(k, dtype)
            for n in (tile - 1, tile, tile + 1, 2 * tile + 1, 3 * tile + 2, 3 * tile + 3):
                lanes = scan_lanes(torch, n, dtype, ops, g)
                for kind in ("none", "p01"):
                    flags = scan_flags(torch, kind, n, g)
                    for reverse in (False, True):
                        compare_scan(torch, lanes, flags, ops, reverse, f"n={n} (tile {tile}) {dtype} k={k} {kind}")
                        edges += 1
            # lanes one element in (4 or 8 bytes) and flags 4 and 1 bytes in: not 16-byte aligned
            n = 5 * tile + 7
            lanes = [v[1:] for v in scan_lanes(torch, n + 1, dtype, ops, g)]
            flag_buf = torch.rand(n + 4, generator=g, device="cuda") < 0.01
            for flags in (None, flag_buf[4:], flag_buf[1:n + 1]):
                for reverse in (False, True):
                    compare_scan(torch, lanes, flags, ops, reverse, f"views {dtype} k={k}")
                    edges += 1
    # races: 20 launches in a row at N = 2^26 + 3, four int64 lanes, each bit-equal
    n, ops = (1 << 26) + 3, SCAN_OPS[4]
    lanes = scan_lanes(torch, n, torch.int64, ops, g)
    for kind in ("none", "every1000"):
        flags = scan_flags(torch, kind, n, g)
        want = _plain_multi_scan(lanes, flags, ops, True)
        bad = torch.zeros((), dtype=torch.bool, device="cuda")
        for _ in range(20):
            for a, b in zip(segment_scan_cuda(lanes, flags, ops, True), want):
                bad |= (a != b).any()
        if bool(bad):
            raise AssertionError(f"a back-to-back launch at n={n} flags={kind} differs from the plain version")
        edges += 20
        del want
    del lanes
    torch.cuda.synchronize()
    emit({"phase": "segscan_kernel_vs_plain", "comparisons": checked + edges, "sizes": list(SCAN_SIZES),
          "edge_comparisons": edges})


def dlrm_data(torch, seed: int):
    """Scores and labels of the Criteo day-23 evaluation split, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    n = DLRM["samples"]
    target = (torch.rand(n, generator=g, device="cuda") < DLRM["positive_rate"]).long()
    z = torch.randn(n, generator=g, device="cuda") + DLRM["positive_shift"] * target
    # a model served in bf16 emits bf16 scores: long tie runs
    scores = torch.sigmoid(z).to(torch.bfloat16).to(torch.float32)
    return scores, target


def dlrm_batches(scores, target, rows: int):
    b = DLRM["batch"]
    return [(scores[s:min(s + b, rows)], target[s:min(s + b, rows)]) for s in range(0, rows, b)]


def curve_metrics(device):
    from metrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision

    return {
        "BinaryAUROC": BinaryAUROC(device=device),
        "BinaryAUROC(max_fpr=0.1)": BinaryAUROC(max_fpr=0.1, device=device),
        "BinaryAveragePrecision": BinaryAveragePrecision(device=device),
    }


def imagenet_metrics(device):
    from metrics_tpu_torch.classification import MulticlassAUROC, MulticlassAveragePrecision

    c = IMAGENET["classes"]
    return {
        "MulticlassAUROC": MulticlassAUROC(num_classes=c, device=device),
        "MulticlassAveragePrecision": MulticlassAveragePrecision(num_classes=c, device=device),
    }


def sorted_run_lanes(torch, scores, target):
    """The sort tier's two scan lanes for all-valid rows, and the sorted positives."""
    from metrics_tpu_torch.ops.clf_curve import _canonical_zero, _run_end_lanes

    sk, order = torch.sort(_canonical_zero(scores.to(torch.float32)), descending=True)
    is_pos = target[order] == 1
    lanes, boundary = _run_end_lanes(sk, is_pos)
    return lanes, boundary


def mann_whitney_auc(torch, scores, target) -> float:
    """float64 AUROC as the Mann-Whitney U statistic with tie-averaged ranks."""
    s, order = torch.sort(scores.to(torch.float64))
    pos = (target[order] == 1).to(torch.float64)
    _, counts = torch.unique_consecutive(s, return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)
    avg_rank = ends - (counts.to(torch.float64) - 1) / 2
    run = torch.repeat_interleave(torch.arange(counts.numel(), device=s.device), counts)
    pos_per_run = torch.zeros(counts.numel(), dtype=torch.float64, device=s.device).index_add_(0, run, pos)
    p = pos.sum()
    q = s.numel() - p
    return float(((pos_per_run * avg_rank).sum() - p * (p + 1) / 2) / (p * q))


def run_end_references(torch, fps, tps, boundary, max_fpr: float):
    """float64 AP and McClish partial AUC from the run-end counts."""
    t = tps[boundary].to(torch.float64)
    f = fps[boundary].to(torch.float64)
    p, q = t[-1], f[-1]
    prev_t = torch.cat([torch.zeros(1, dtype=torch.float64, device=t.device), t[:-1]])
    ap = float(((t - prev_t) / p * t / (t + f)).sum())
    zero = torch.zeros(1, dtype=torch.float64, device=t.device)
    fpr, tpr = torch.cat([zero, f / q]), torch.cat([zero, t / p])
    stop = int(torch.searchsorted(fpr, torch.tensor([max_fpr], dtype=torch.float64, device=t.device), right=True))
    lo, hi = max(stop - 1, 0), min(stop, fpr.numel() - 1)
    step = float(fpr[hi] - fpr[lo])
    w = (max_fpr - float(fpr[lo])) / step if step > 0 else 0.0
    interp = tpr[lo] + w * (tpr[hi] - tpr[lo])
    x = torch.clamp(fpr, max=max_fpr)
    y = torch.where(fpr > max_fpr, interp, tpr)
    partial = float((torch.diff(x) * (y[1:] + y[:-1]) / 2).sum())
    min_area = 0.5 * max_fpr**2
    return ap, 0.5 * (1 + (partial - min_area) / (max_fpr - min_area))


def device_events(prof) -> dict:
    """(name, device microseconds) of each kernel or copy in a profiler trace, summed by name."""
    totals = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            totals[evt.key] = totals.get(evt.key, 0.0) + us
    return totals


def device_ms(torch, fn, reps: int = 10) -> dict:
    """Device ms per ``fn()`` call of each kernel and memset, by name, from a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {k[:70]: v / reps / 1e3 for k, v in device_events(prof).items()}


def phase_curve_path(torch, seed: int):
    from metrics_tpu_torch.ops.clf_curve import _fps_tps_from_scan, _run_end_counts
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    scores, target = dlrm_data(torch, seed)
    n = scores.numel()
    batches = dlrm_batches(scores, target, n)
    gpu = curve_metrics("cuda")
    torch.cuda.synchronize()

    segment_scan_cuda.launches = 0  # ---- DLRM path starts
    t0 = time.perf_counter()
    for preds, labels in batches:
        for metric in gpu.values():
            metric.update(preds, labels)
    values = {name: metric.compute() for name, metric in gpu.items()}
    torch.cuda.synchronize()
    dlrm_s = time.perf_counter() - t0
    dlrm_launches = segment_scan_cuda.launches  # ---- DLRM path ends
    if len(batches) != 1361 or batches[-1][0].numel() != 8359:
        raise AssertionError(f"expected 1361 updates, the last of 8359 rows; got {len(batches)}")
    if dlrm_launches != len(gpu):
        raise AssertionError(f"DLRM path launched the scan kernel {dlrm_launches} times, not {len(gpu)}")

    gi = torch.Generator(device="cuda").manual_seed(seed + 3)
    c, m = IMAGENET["classes"], IMAGENET["samples"]
    probs = torch.softmax(2.0 * torch.randn((m, c), generator=gi, device="cuda"), dim=1)
    labels_in = torch.randint(0, c, (m,), generator=gi, device="cuda")
    imagenet = imagenet_metrics("cuda")
    torch.cuda.synchronize()
    segment_scan_cuda.launches = 0  # ---- ImageNet path starts
    for s in range(0, m, IMAGENET["batch"]):
        for metric in imagenet.values():
            metric.update(probs[s:s + IMAGENET["batch"]], labels_in[s:s + IMAGENET["batch"]])
    imagenet_values = {name: metric.compute() for name, metric in imagenet.items()}
    torch.cuda.synchronize()
    imagenet_launches = segment_scan_cuda.launches  # ---- ImageNet path ends
    if imagenet_launches != len(imagenet) * c:
        raise AssertionError(f"ImageNet path launched the scan kernel {imagenet_launches} times, not {2 * c}")

    for name, value in {**values, **imagenet_values}.items():
        if value.shape != () or not bool(torch.isfinite(value)) or not 0.0 <= value.item() <= 1.0:
            raise AssertionError(f"{name}: expected a finite scalar in [0, 1], got {value}")

    # the same sorted inputs through the kernel and the plain version
    lanes, boundary = sorted_run_lanes(torch, scores, target)
    n_valid = torch.tensor(n, dtype=torch.int32, device="cuda")
    kernel_counts = _fps_tps_from_scan(*segment_scan_cuda(lanes, None, ("min", "min"), True), n_valid)
    plain_counts = _fps_tps_from_scan(*_plain_multi_scan(lanes, None, ("min", "min"), True), n_valid)
    if not all(torch.equal(a, b) for a, b in zip(kernel_counts, plain_counts)):
        raise AssertionError("(fps, tps) through the scan kernel differ from the plain version's")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    sort_tier = _run_end_counts(scores, target, valid, "sort")
    rank_tier = _run_end_counts(scores, target, valid, "rank")
    if not all(torch.equal(a, b) for a, b in zip(sort_tier, rank_tier)):
        raise AssertionError("the sort and rank tiers differ on the card")
    if not torch.equal(sort_tier[3], boundary) or not all(torch.equal(a, b) for a, b in zip(sort_tier, kernel_counts)):
        raise AssertionError("the metric path's run-end counts differ from the sorted inputs' kernel run")

    # float64 references on the card
    fps, tps = plain_counts
    auc64 = mann_whitney_auc(torch, scores, target)
    ap64, pauc64 = run_end_references(torch, fps, tps, boundary, 0.1)
    refs = {"BinaryAUROC": auc64, "BinaryAUROC(max_fpr=0.1)": pauc64, "BinaryAveragePrecision": ap64}
    ref_err = {name: abs(values[name].item() - ref) for name, ref in refs.items()}
    for name, err in ref_err.items():
        if err > 1e-5:
            raise AssertionError(f"{name}: {values[name].item()} on the card vs float64 {refs[name]}")
    del lanes, boundary, kernel_counts, plain_counts, sort_tier, rank_tier, fps, tps

    # a CPU run of the port on the first 2^22 rows, against the card on the same rows
    cpu_diff = {}
    small_gpu, small_cpu = curve_metrics("cuda"), curve_metrics("cpu")
    for preds, labels in dlrm_batches(scores, target, CPU_CHECK_ROWS):
        preds_cpu, labels_cpu = preds.cpu(), labels.cpu()
        for name in small_gpu:
            small_gpu[name].update(preds, labels)
            small_cpu[name].update(preds_cpu, labels_cpu)
    imagenet_cpu = imagenet_metrics("cpu")
    probs_cpu, labels_in_cpu = probs.cpu(), labels_in.cpu()
    for s in range(0, m, IMAGENET["batch"]):
        for metric in imagenet_cpu.values():
            metric.update(probs_cpu[s:s + IMAGENET["batch"]], labels_in_cpu[s:s + IMAGENET["batch"]])
    pairs = [(f"{k}[:2^22]", small_gpu[k].compute(), small_cpu[k].compute()) for k in small_gpu]
    pairs += [(k, imagenet_values[k], imagenet_cpu[k].compute()) for k in imagenet]
    for name, got, want in pairs:
        cpu_diff[name] = abs(got.item() - want.item())
        if cpu_diff[name] > 1e-6:
            raise AssertionError(f"{name}: {got.item()} on the card vs {want.item()} on the CPU")

    emit({
        "phase": "curve_path",
        "dlrm": {"samples": n, "updates": len(batches), "positives": int(target.sum()),
                 "values": {k: v.item() for k, v in values.items()}, "float64_reference": refs,
                 "abs_err_vs_float64": ref_err, "scan_launches": dlrm_launches, "seconds_incl_validation": dlrm_s},
        "imagenet": {"samples": m, "classes": c, "values": {k: v.item() for k, v in imagenet_values.items()},
                     "scan_launches": imagenet_launches},
        "abs_diff_vs_cpu": cpu_diff,
    })
    # one class's scores and labels: the ImageNet path's scan shape (50,000 rows)
    imagenet_class = (probs[:, 0].contiguous(), (labels_in == 0).long())
    return gpu, batches[0], imagenet, (probs[:IMAGENET["batch"]], labels_in[:IMAGENET["batch"]]), imagenet_class, (
        scores, target, dlrm_launches + imagenet_launches
    )


def phase_curve_timing(torch, gpu, batch, imagenet, imagenet_batch, imagenet_class, dlrm, smi: str):
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    def compute_ms(metric, reps):
        def run():
            metric._computed = None  # time the computation, not the cached value
            metric.compute()
        return event_ms(torch, run, reps=reps, warmup=1)

    timing = {}
    for name, metric in gpu.items():
        kwargs = {"max_fpr": metric.max_fpr} if hasattr(metric, "max_fpr") else {}
        fresh = type(metric)(device="cuda", **kwargs)
        timing[name] = {"update_ms": event_ms(torch, lambda: fresh.update(*batch), reps=10),
                        "compute_ms": compute_ms(metric, 5)}
    for name, metric in imagenet.items():
        fresh = type(metric)(num_classes=IMAGENET["classes"], device="cuda")
        timing[name] = {"update_ms": event_ms(torch, lambda: fresh.update(*imagenet_batch), reps=10),
                        "compute_ms": compute_ms(metric, 3)}

    scores, target, launches = dlrm
    # the kernel on the DLRM compute's own inputs: 2 int32 min lanes, one segment, reverse;
    # timed in turns (kernel, plain, library, kernel): the plain version and torch.cummin
    # scan a 1-D tensor in ~0.5 s each, so they take fewer repetitions
    lanes, _ = sorted_run_lanes(torch, scores, target)
    ops = ("min", "min")
    flipped = [lane.flip(0).contiguous() for lane in lanes]
    kernel_first_ms = event_ms(torch, lambda: segment_scan_cuda(lanes, None, ops, True), warmup=10)
    plain_ms = event_ms(torch, lambda: _plain_multi_scan(lanes, None, ops, True), reps=5, warmup=1)
    library_ms = event_ms(torch, lambda: [torch.cummin(f, 0) for f in flipped], reps=5, warmup=1)
    kernel_ms = event_ms(torch, lambda: segment_scan_cuda(lanes, None, ops, True), warmup=10)
    kernel_b2b_ms = back_to_back_ms(torch, lambda: segment_scan_cuda(lanes, None, ops, True))
    got = segment_scan_cuda(lanes, None, ops, True)
    want = _plain_multi_scan(lanes, None, ops, True)
    lib = [torch.cummin(f, 0).values.flip(0) for f in flipped]
    max_abs_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    if max_abs_err != 0 or not all(torch.equal(a, c) for a, c in zip(want, lib)):
        raise AssertionError("scan kernel, plain version and torch.cummin disagree on the curve-path inputs")
    n, k = lanes[0].numel(), len(lanes)
    bound_ms = n * k * 2 * lanes[0].element_size() / HBM_BYTES_PER_S * 1e3

    # the library yardstick: one int32 sum lane of the same length, no flags, forward,
    # through the kernel and through torch.cumsum (CUB's single-pass scan), in turns
    sum_lane = lanes[0]
    sum_kernel = lambda: segment_scan_cuda([sum_lane], None, ("sum",), False)  # noqa: E731
    cumsum = lambda: torch.cumsum(sum_lane, 0, dtype=torch.int32)  # noqa: E731
    if not torch.equal(sum_kernel()[0], cumsum()):
        raise AssertionError("scan kernel and torch.cumsum disagree on the sum lane")
    cumsum_ms = [event_ms(torch, cumsum, warmup=10)]
    sum_kernel_ms = [event_ms(torch, sum_kernel, warmup=10) for _ in range(2)]
    cumsum_ms.append(event_ms(torch, cumsum, warmup=10))
    back_to_back = {"kernel_ms": [], "torch_cumsum_ms": []}
    for key, fn in (("torch_cumsum_ms", cumsum), ("kernel_ms", sum_kernel), ("kernel_ms", sum_kernel),
                    ("torch_cumsum_ms", cumsum)):
        back_to_back[key].append(back_to_back_ms(torch, fn))
    sum_bound_ms = n * 2 * sum_lane.element_size() / HBM_BYTES_PER_S * 1e3

    # the ImageNet path's shape: one class, 50,000 rows, the same two lanes, reverse
    small, _ = sorted_run_lanes(torch, *imagenet_class)
    small_want = _plain_multi_scan(small, None, ops, True)
    if not all(torch.equal(a, b) for a, b in zip(segment_scan_cuda(small, None, ops, True), small_want)):
        raise AssertionError("scan kernel and plain version disagree at the ImageNet shape")
    small_ms = event_ms(torch, lambda: segment_scan_cuda(small, None, ops, True), reps=100, warmup=10)
    small_plain_ms = event_ms(torch, lambda: _plain_multi_scan(small, None, ops, True), reps=100, warmup=10)
    small_cumsum_ms = event_ms(torch, lambda: torch.cumsum(small[0], 0, dtype=torch.int32), reps=100, warmup=10)
    m = small[0].numel()
    small_bound_ms = m * k * 2 * small[0].element_size() / HBM_BYTES_PER_S * 1e3
    emit({"phase": "curve_timing", "card": smi, "metrics": timing,
          "segment_scan": {"n": n, "lanes": k, "kernel_ms": kernel_ms, "kernel_ms_first_turn": kernel_first_ms,
                           "kernel_ms_back_to_back": kernel_b2b_ms,
                           "plain_ms": plain_ms, "torch_cummin_ms": library_ms, "bound_ms": bound_ms,
                           "kernel_share_of_bound": bound_ms / kernel_ms},
          "segment_scan_sum_lane": {"n": n, "kernel_ms": sum_kernel_ms, "torch_cumsum_ms": cumsum_ms,
                                    "back_to_back": back_to_back, "bound_ms": sum_bound_ms},
          "segment_scan_imagenet_shape": {"n": m, "lanes": k, "kernel_ms": small_ms, "plain_ms": small_plain_ms,
                                          "torch_cumsum_ms": small_cumsum_ms, "bound_ms": small_bound_ms}})
    return {
        "name": "segment_scan",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/segment_scan.cu",
        "replaces": "metrics_tpu/ops/segment.py:304",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": statistics.median(cumsum_ms),
    }


def phase_timing(torch, gpu, batch, launches: int, smi: str, seed: int):
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    logits, target = batch
    c = CITYSCAPES["classes"]
    update_ms = {}
    for name, metric in gpu.items():
        update_ms[name] = event_ms(torch, lambda: metric.update(logits, target), reps=10)

    # the kernel's inputs on the main path: int32 ids in [0, 361) and the valid mask
    ids, mask = histogram_inputs(torch, target, logits.argmax(1))
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
    # the same shape with neighbouring pixels sharing their (target, prediction) pair
    coherent_ids, coherent_mask = coherent_histogram_inputs(torch, torch.Generator(device="cuda").manual_seed(seed + 4))
    if not torch.equal(histogram_cuda(coherent_ids, coherent_mask, bins),
                       _plain_bincount(coherent_ids, coherent_mask, bins)):
        raise AssertionError("kernel and plain version disagree on the coherent input")
    coherent_ms = event_ms(torch, lambda: histogram_cuda(coherent_ids, coherent_mask, bins))
    b2b_ms = {"kernel_ms": back_to_back_ms(torch, lambda: histogram_cuda(ids, mask, bins)),
              "coherent_kernel_ms": back_to_back_ms(torch, lambda: histogram_cuda(coherent_ids, coherent_mask, bins)),
              "torch_bincount_ms": back_to_back_ms(torch, lambda: torch.bincount(ids, weights=mask_f, minlength=bins))}
    bytes_moved = n * ids.element_size() + n * mask.element_size() + bins * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    emit({"phase": "timing", "card": smi, "update_ms_median": update_ms,
          "histogram": {"n": n, "bins": bins, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                        "torch_bincount_ms": library_ms, "bound_ms": bound_ms,
                        "kernel_share_of_bound": bound_ms / kernel_ms, "coherent_kernel_ms": coherent_ms,
                        "coherent_over_uniform": coherent_ms / kernel_ms, "back_to_back": b2b_ms}})
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


def msmarco_batches(torch, seed: int):
    """The MS MARCO dev evaluation drawn on the card: 70 updates of 100 queries, each
    ``(preds, target, indexes)`` with its rows shuffled; query ids in random order."""
    c = MSMARCO
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    q, d = c["queries"], c["depth"]
    u = torch.rand(q, generator=g, device="cuda")
    n_rel = sum((u >= edge).to(torch.int64) for edge in c["relevant_count_cdf"])  # 0, 1, 2 or 3
    target = (torch.arange(d, device="cuda")[None, :] < n_rel[:, None]).to(torch.int64)
    scores = (torch.randn((q, d), generator=g, device="cuda") + c["relevant_shift"] * target)
    scores = scores.to(torch.bfloat16).to(torch.float32)  # a model served in bf16: real ties
    order = torch.randperm(q, generator=g, device="cuda")
    batches = []
    for start in range(0, q, c["batch_queries"]):
        ids = order[start:start + c["batch_queries"]]
        perm = torch.randperm(ids.numel() * d, generator=g, device="cuda")
        batches.append((scores[ids].reshape(-1)[perm], target[ids].reshape(-1)[perm],
                        ids.repeat_interleave(d)[perm]))
    return batches


def retrieval_metrics(cat_capacity=None):
    from metrics_tpu_torch.retrieval import (
        RetrievalMAP,
        RetrievalMRR,
        RetrievalNormalizedDCG,
        RetrievalPrecision,
        RetrievalRPrecision,
    )

    kw = {} if cat_capacity is None else {"cat_capacity": cat_capacity}
    return {
        "RetrievalMRR": RetrievalMRR(**kw),
        "RetrievalMAP": RetrievalMAP(**kw),
        "RetrievalNormalizedDCG(top_k=10)": RetrievalNormalizedDCG(top_k=10, **kw),
        "RetrievalPrecision(top_k=10)": RetrievalPrecision(top_k=10, **kw),
        "RetrievalRPrecision": RetrievalRPrecision(**kw),
    }


def msmarco_reference(torch, batches) -> dict:
    """float64 values of the five metrics on the dense (queries, depth) layout: each
    query's candidates in the order they were fed, a stable sort by descending score,
    then closed forms; queries without a relevant candidate score 0."""
    q, d = MSMARCO["queries"], MSMARCO["depth"]
    preds, target, indexes = (torch.cat(col) for col in zip(*batches))
    order = torch.sort(indexes, stable=True).indices
    preds, target = preds[order].reshape(q, d).double(), target[order].reshape(q, d)
    ranked = torch.gather(target, 1, torch.sort(-preds, dim=1, stable=True).indices).double()
    n_rel = ranked.sum(1)
    has = n_rel > 0
    k = torch.arange(1, d + 1, device=ranked.device, dtype=torch.float64)
    first = torch.where(ranked > 0, k, float(d + 1)).min(1).values
    mrr = torch.where(has, 1.0 / first, 0.0)
    ap = torch.where(has, (ranked * ranked.cumsum(1) / k).sum(1) / n_rel.clamp_min(1), 0.0)
    disc = 1.0 / torch.log2(k[:10] + 1.0)
    idcg = (disc[None, :] * (k[None, :10] <= n_rel[:, None])).sum(1)
    ndcg = torch.where(has, (ranked[:, :10] * disc).sum(1) / idcg.clamp_min(1e-12), 0.0)
    p10 = ranked[:, :10].sum(1) / 10.0
    r_prec = torch.where(has, (ranked * (k[None, :] <= n_rel[:, None])).sum(1) / n_rel.clamp_min(1), 0.0)
    return {"RetrievalMRR": mrr.mean().item(), "RetrievalMAP": ap.mean().item(),
            "RetrievalNormalizedDCG(top_k=10)": ndcg.mean().item(),
            "RetrievalPrecision(top_k=10)": p10.mean().item(), "RetrievalRPrecision": r_prec.mean().item()}


class RecordingScan:
    """Stands in for the scan wrapper: launches the kernel, keeps each call's lanes."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, []

    def __call__(self, values, flags, ops, reverse=False):
        outs = self.kernel(values, flags, ops, reverse)
        self.calls.append((tuple(values), flags, tuple(ops), reverse, outs))
        return outs


# the scan calls of one evaluation of the five metrics, in order (MRR, MAP, NDCG, P@10, R-precision)
RETRIEVAL_LANE_SETS = [(("sum", "sum", "min"), False), (("sum", "sum"), False), (("sum", "sum"), False),
                       (("sum", "sum"), False), (("sum",), False), (("sum", "sum"), False), (("sum",), True),
                       (("sum",), False)]


def phase_retrieval_path(torch, seed: int):
    from metrics_tpu_torch.ops import segment
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    batches = msmarco_batches(torch, seed)
    n = sum(b[0].numel() for b in batches)
    if len(batches) != 70 or n != 6_980_000:
        raise AssertionError(f"expected 70 updates and 6,980,000 rows, got {len(batches)} and {n}")
    runs = {"list": retrieval_metrics(), "cat_capacity": retrieval_metrics(CAT_CAPACITY)}
    torch.cuda.synchronize()

    values, per_evaluation, seconds = {}, {}, {}
    segment_scan_cuda.launches = 0  # ---- retrieval path starts
    for kind, metrics in runs.items():
        t0 = time.perf_counter()
        for preds, target, indexes in batches:
            for metric in metrics.values():
                metric.update(preds, target, indexes=indexes)
        before = segment_scan_cuda.launches
        values[kind] = {name: metric.compute() for name, metric in metrics.items()}
        torch.cuda.synchronize()
        per_evaluation[kind] = segment_scan_cuda.launches - before
        seconds[kind] = time.perf_counter() - t0
    launches = segment_scan_cuda.launches  # ---- retrieval path ends

    for kind, count in per_evaluation.items():
        if count != len(RETRIEVAL_LANE_SETS):
            raise AssertionError(f"one {kind} evaluation launched the scan kernel {count} times, not 8")
    if launches != 2 * len(RETRIEVAL_LANE_SETS):
        raise AssertionError(f"the retrieval path launched the scan kernel {launches} times, not 16")
    for name in values["list"]:
        a, b = values["list"][name], values["cat_capacity"][name]
        if a.shape != () or not bool(torch.isfinite(a)) or not torch.equal(a, b):
            raise AssertionError(f"{name}: list states {a} and cat_capacity states {b} differ or are not finite")
    if not all(m.indexes.valid_count() == n and not m.indexes.overflowed() for m in runs["cat_capacity"].values()):
        raise AssertionError("a cat_capacity state does not hold every row")
    refs = msmarco_reference(torch, batches)
    ref_err = {name: abs(values["list"][name].item() - ref) for name, ref in refs.items()}
    for name, err in ref_err.items():
        if err > 1e-5:
            raise AssertionError(f"{name}: {values['list'][name].item()} on the card vs float64 {refs[name]}")

    # one more evaluation, each launch held against the plain scan on its own lanes and flags
    recorder = RecordingScan(segment_scan_cuda)
    segment.segment_scan_cuda = recorder
    try:
        for metric in runs["list"].values():
            metric._computed = None
            metric.compute()
    finally:
        segment.segment_scan_cuda = segment_scan_cuda
    if [(ops, reverse) for _, _, ops, reverse, _ in recorder.calls] != RETRIEVAL_LANE_SETS:
        raise AssertionError(f"unexpected retrieval lane sets: {[c[2:4] for c in recorder.calls]}")
    for lanes, flags, ops, reverse, outs in recorder.calls:
        if flags is None or any(v.dtype != torch.int32 for v in lanes):
            raise AssertionError("a retrieval scan ran without segment flags or on other than int32 lanes")
        for a, b in zip(outs, _plain_multi_scan(lanes, flags, ops, reverse)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"scan kernel != plain on the retrieval lanes ops={ops} reverse={reverse}")
    emit({"phase": "retrieval_path", "rows": n, "queries": MSMARCO["queries"], "updates": len(batches),
          "values": {k: v.item() for k, v in values["list"].items()}, "float64_reference": refs,
          "abs_err_vs_float64": ref_err, "list_equals_cat_capacity": True,
          "scan_launches_per_evaluation": per_evaluation, "scan_launches": launches,
          "launches_bit_equal_to_plain": len(recorder.calls), "seconds_incl_updates": seconds})
    return runs, batches[0], recorder.calls, launches


def phase_retrieval_timing(torch, runs, batch, calls, smi: str) -> None:
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    def compute_ms(metric):
        def run():
            metric._computed = None  # time the computation, not the cached value
            metric.compute()
        return event_ms(torch, run, reps=5, warmup=1)

    preds, target, indexes = batch
    timing = {}
    for name, metric in runs["list"].items():
        top_k = getattr(metric, "top_k", None)
        fresh = type(metric)(**({} if top_k is None else {"top_k": top_k}))
        timing[name] = {"update_ms": event_ms(torch, lambda: fresh.update(preds, target, indexes=indexes), reps=10),
                        "compute_ms": compute_ms(metric),
                        "compute_ms_cat_capacity": compute_ms(runs["cat_capacity"][name])}
    # the kernel at this shape: MRR's pass A (three lanes), MAP's pass A (two), P@10's pass B (one)
    kernel = {}
    for label, index in (("mrr_pass_a", 0), ("map_pass_a", 1), ("p10_pass_b", 4)):
        lanes, flags, ops, reverse, _ = calls[index]
        n, k = lanes[0].numel(), len(lanes)
        call = lambda: segment_scan_cuda(lanes, flags, ops, reverse)  # noqa: E731
        dev = device_ms(torch, call)
        kernel[label] = {
            "n": n, "lanes": k, "ops": list(ops), "kernel_ms": event_ms(torch, call, warmup=10),
            "kernel_ms_back_to_back": back_to_back_ms(torch, call),
            "device_ms": sum(v for key, v in dev.items() if "segment_scan" in key), "device_ms_by_name": dev,
            "plain_ms": event_ms(torch, lambda: _plain_multi_scan(lanes, flags, ops, reverse), reps=5, warmup=1),
            # each int32 lane read once and written once, the bool flag column read once
            "bound_ms": n * (k * 2 * 4 + 1) / HBM_BYTES_PER_S * 1e3,
        }
    lane = calls[0][0][0]
    cumsum = lambda: torch.cumsum(lane, 0, dtype=torch.int32)  # noqa: E731
    kernel["torch_cumsum_ms_one_int32_lane"] = event_ms(torch, cumsum, warmup=10)
    kernel["torch_cumsum_ms_one_int32_lane_back_to_back"] = back_to_back_ms(torch, cumsum)
    emit({"phase": "retrieval_timing", "card": smi, "metrics": timing, "segment_scan": kernel})


def collection_metrics(device, **kwargs):
    """The Cityscapes evaluation's nine stat-scores and confusion metrics, by name."""
    from metrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassCohenKappa,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassJaccardIndex,
        MulticlassMatthewsCorrCoef,
        MulticlassPrecision,
        MulticlassRecall,
        MulticlassSpecificity,
    )

    c, ii = CITYSCAPES["classes"], CITYSCAPES["ignore_index"]
    macro = dict(num_classes=c, average="macro", ignore_index=ii, device=device, **kwargs)
    plain = dict(num_classes=c, ignore_index=ii, device=device, **kwargs)
    return {
        "MulticlassAccuracy": MulticlassAccuracy(**macro), "MulticlassPrecision": MulticlassPrecision(**macro),
        "MulticlassRecall": MulticlassRecall(**macro), "MulticlassF1Score": MulticlassF1Score(**macro),
        "MulticlassSpecificity": MulticlassSpecificity(**macro),
        "MulticlassJaccardIndex": MulticlassJaccardIndex(**plain),
        "MulticlassConfusionMatrix": MulticlassConfusionMatrix(**plain),
        "MulticlassCohenKappa": MulticlassCohenKappa(**plain),
        "MulticlassMatthewsCorrCoef": MulticlassMatthewsCorrCoef(**plain),
    }


def check_groups(collection) -> None:
    got = {frozenset(v) for v in collection.compute_groups.values()}
    if got != {frozenset(v) for v in COLLECTION_GROUPS}:
        raise AssertionError(f"compute groups {collection.compute_groups} differ from {COLLECTION_GROUPS}")


def phase_collection(torch, seed: int, smi: str):
    """The Cityscapes evaluation through one MetricCollection of nine metrics (two
    compute groups), a MeanMetric and a CompositionalMetric beside it."""
    from metrics_tpu_torch.classification import MulticlassPrecision, MulticlassRecall
    from metrics_tpu_torch.core import MeanMetric, MetricCollection
    from metrics_tpu_torch.ops.histogram import histogram_cuda

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    batches = [cityscapes_batch(torch, g) for _ in range(UPDATES)]
    c, ii = CITYSCAPES["classes"], CITYSCAPES["ignore_index"]
    collection = MetricCollection(collection_metrics("cuda"))
    check_groups(collection)
    apart = collection_metrics("cuda")
    pixel_accuracy = MeanMetric()
    precision = MulticlassPrecision(c, average="macro", ignore_index=ii)
    recall = MulticlassRecall(c, average="macro", ignore_index=ii)
    f1_of_means = 2 * (precision * recall) / (precision + recall)
    torch.cuda.synchronize()

    histogram_cuda.launches = 0  # ---- collection path starts
    for logits, target in batches:
        collection.update(logits, target)
    values = collection.compute()
    torch.cuda.synchronize()
    launches = histogram_cuda.launches  # ---- collection path ends
    groups = len(collection.compute_groups)
    if launches != groups * UPDATES:
        raise AssertionError(f"the collection launched the histogram kernel {launches} times, not {groups * UPDATES}")

    histogram_cuda.launches = 0  # ---- the path's MeanMetric and composition start
    for logits, target in batches:
        valid = target != ii
        pixel_accuracy.update(((logits.argmax(1) == target) & valid).sum() / valid.sum())
        f1_of_means.update(logits, target)
    mean_value, composed_value = pixel_accuracy.compute(), f1_of_means.compute()
    torch.cuda.synchronize()
    alongside_launches = histogram_cuda.launches  # ---- they end
    # precision and recall each appear twice in the tree, and each appearance updates them
    if alongside_launches != 4 * UPDATES:
        raise AssertionError(f"the composition launched the histogram kernel {alongside_launches} times, not 12")

    # checks: the nine metrics apart, the plain confusion matrix, float64 pixel accuracy
    before = histogram_cuda.launches
    for logits, target in batches:
        for metric in apart.values():
            metric.update(logits, target)
    apart_values = {name: metric.compute() for name, metric in apart.items()}
    torch.cuda.synchronize()
    apart_launches = histogram_cuda.launches - before
    if apart_launches != len(apart) * UPDATES:
        raise AssertionError(f"nine metrics apart launched the histogram kernel {apart_launches} times")
    for name, value in values.items():
        if value.dtype != apart_values[name].dtype or not torch.equal(value, apart_values[name]):
            raise AssertionError(f"{name}: {value} in the collection vs {apart_values[name]} apart")
        if not bool(torch.isfinite(value.double()).all()):
            raise AssertionError(f"{name}: not finite: {value}")
    reference = sum(plain_confmat(torch, logits, target) for logits, target in batches)
    if not torch.equal(values["MulticlassConfusionMatrix"], reference):
        raise AssertionError("the collection's confusion matrix differs from the plain histogram")
    p, r = apart_values["MulticlassPrecision"], apart_values["MulticlassRecall"]
    want = torch.true_divide(torch.multiply(torch.tensor(2, device="cuda"), torch.multiply(p, r)), torch.add(p, r))
    if not torch.equal(composed_value, want):
        raise AssertionError(f"2PR/(P+R) composition {composed_value} vs {want}")
    per_batch = [float((((lg.argmax(1) == t) & (t != ii)).sum().double() / (t != ii).sum().double()))
                 for lg, t in batches]
    mean_err = abs(mean_value.item() - sum(per_batch) / len(per_batch))
    if mean_err > 1e-6:
        raise AssertionError(f"MeanMetric of the pixel accuracy off by {mean_err}")

    logits, target = batches[0]
    timing = {
        "collection_update_ms": event_ms(torch, lambda: collection.update(logits, target), reps=10),
        "nine_updates_apart_ms": event_ms(torch, lambda: [m.update(logits, target) for m in apart.values()], reps=10),
        "sum_of_nine_update_ms": sum(event_ms(torch, lambda: m.update(logits, target), reps=10)
                                     for m in apart.values()),
    }
    emit({"phase": "collection", "card": smi, "updates": UPDATES,
          "compute_groups": {k: list(v) for k, v in collection.compute_groups.items()},
          "histogram_launches": {"collection": launches, "mean_and_composition": alongside_launches,
                                 "nine_apart": apart_launches},
          "values": {k: v.item() for k, v in values.items() if v.dim() == 0},
          "pixel_accuracy_mean": mean_value.item(), "f1_of_macro_means": composed_value.item(),
          "bit_equal_to_apart": True, "timing": timing})
    return batches, values, launches + alongside_launches


def snapshot_states(metric) -> dict:
    from metrics_tpu_torch.core.state import CatBuffer

    snap = {}
    for name in metric._defaults:
        value = getattr(metric, name)
        if isinstance(value, CatBuffer):
            snap[name] = ("buffer", value.values().clone())
        elif isinstance(value, list):
            snap[name] = ("list", [v.clone() for v in value])
        else:
            snap[name] = ("tensor", value.clone())
    return snap


def states_equal(a: dict, b: dict) -> bool:
    import torch

    for name, (kind, value) in a.items():
        kind_b, value_b = b[name]
        if kind != kind_b:
            return False
        pairs = zip(value, value_b) if kind == "list" else [(value, value_b)]
        if kind == "list" and len(value) != len(value_b):
            return False
        if not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs):
            return False
    return True


def synced_compute(torch, metric):
    """``compute`` (which syncs), checking that the live states come back bit-equal."""
    before = snapshot_states(metric)
    value = metric.compute()
    if metric._is_synced or not states_equal(before, snapshot_states(metric)):
        raise AssertionError(f"{type(metric).__name__}: the live states did not come back after the synced compute")
    return value


def sync_ms(torch, metric, reps: int = 5) -> float:
    """Median host time of one ``sync()`` (to the device's end) and ``unsync()``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.sync()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metric.unsync()
    return statistics.median(times)


def phase_sync_nccl(torch, seed: int, batches, collection_values, map_value, smi: str):
    """An NCCL group of one rank: the collection, a samplewise ExactMatch and
    RetrievalMAP over MS MARCO sync at ``compute`` through ``all_gather``."""
    import torch.distributed as dist

    from metrics_tpu_torch.classification import MulticlassExactMatch
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.core.state import CatBuffer
    from metrics_tpu_torch.ops.histogram import histogram_cuda
    from metrics_tpu_torch.ops.segment import segment_scan_cuda
    from metrics_tpu_torch.retrieval import RetrievalMAP
    from metrics_tpu_torch.utils.distributed import all_gather_ragged
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sync", f"nccl-{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        # at one rank gather_all_tensors returns its input; its collective body runs the all_gather
        sync = {"dist_sync_fn": all_gather_ragged, "distributed_available_fn": lambda: True}
        c, ii = CITYSCAPES["classes"], CITYSCAPES["ignore_index"]
        collection = MetricCollection(collection_metrics("cuda", **sync))
        check_groups(collection)
        exact, exact_local = (MulticlassExactMatch(c, multidim_average="samplewise", ignore_index=ii, **kw)
                              for kw in (sync, {}))
        msmarco = msmarco_batches(torch, seed)
        maps = {"list": RetrievalMAP(**sync), "cat_capacity": RetrievalMAP(cat_capacity=CAT_CAPACITY, **sync)}
        torch.cuda.synchronize()

        histogram_cuda.launches = segment_scan_cuda.launches = 0  # ---- NCCL sync path starts
        t0 = time.perf_counter()
        for logits, target in batches:
            collection.update(logits, target)
            # every other image predicted exactly: a cat state of bools with both values
            even = torch.arange(target.shape[0], device="cuda")[:, None, None] % 2 == 0
            preds = torch.where(even, target.masked_fill(target == ii, 0), logits.argmax(1))
            exact.update(preds, target)
            exact_local.update(preds, target)
        synced = {name: synced_compute(torch, m) for name, m in collection.items(keep_base=True, copy_state=False)}
        exact_value = synced_compute(torch, exact)
        for preds, target, indexes in msmarco:
            for metric in maps.values():
                metric.update(preds, target, indexes=indexes)
        map_values = {kind: synced_compute(torch, m) for kind, m in maps.items()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"histogram": histogram_cuda.launches, "segment_scan": segment_scan_cuda.launches}
        # ---- NCCL sync path ends
        if launches != {"histogram": 2 * UPDATES, "segment_scan": 2}:
            raise AssertionError(f"NCCL sync path launches {launches}, expected 6 histogram and 2 scan")

        for name, value in synced.items():
            if not torch.equal(value, collection_values[name]):
                raise AssertionError(f"{name}: synced {value} vs unsynced {collection_values[name]}")
        exact_want = exact_local.compute()
        if exact_value.shape != (UPDATES * CITYSCAPES["batch"],) or not torch.equal(exact_value, exact_want):
            raise AssertionError(f"samplewise ExactMatch synced {exact_value} vs unsynced {exact_want}")
        if not torch.equal(exact_value[::2], torch.ones_like(exact_value[::2])):
            raise AssertionError("an exactly predicted image did not count as a match")
        for kind, value in map_values.items():
            if not torch.equal(value, map_value):
                raise AssertionError(f"RetrievalMAP ({kind}) synced {value} vs unsynced {map_value}")
        if not all(isinstance(getattr(maps["cat_capacity"], s), CatBuffer) for s in maps["cat_capacity"]._defaults):
            raise AssertionError("unsync did not restore the CatBuffer states")
        member = collection.__getitem__("MulticlassCohenKappa", copy_state=False)
        member.sync()
        try:
            member.sync()
        except MetricsUserError:
            pass
        else:
            raise AssertionError("a second sync() without unsync() did not raise")
        member.unsync()

        members = list(collection.values(copy_state=False))
        timing = {
            "collection_sync_ms_per_metric": {type(m).__name__: sync_ms(torch, m) for m in members},
            "exact_match_sync_ms": sync_ms(torch, exact),
            "retrieval_map_sync_ms": {kind: sync_ms(torch, m, reps=3) for kind, m in maps.items()},
        }
        timing["collection_sync_ms"] = sum(timing["collection_sync_ms_per_metric"].values())
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    emit({"phase": "sync_nccl", "card": smi, "backend": "nccl", "world_size": 1, "rows": sum(b[0].numel() for b in msmarco),
          "launches": launches, "synced_equal_unsynced": True, "retrieval_map": map_values["list"].item(),
          "exact_match_rows": exact_value.numel(), "seconds_incl_updates": seconds, "timing": timing})
    return launches


def rank_cityscapes_batches(torch, seed: int, rank: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 10 + rank)
    return [cityscapes_batch(torch, g) for _ in range(RANK_BATCHES)]


def rank_msmarco_share(batches, rank: int):
    lo = sum(MSMARCO_RANK_UPDATES[:rank])
    return batches[lo:lo + MSMARCO_RANK_UPDATES[rank]]


def rank_main(rank: int, world: int, store: str, out_dir: str, seed: int) -> None:
    """One rank of the ``sync_ranks`` phase, in its own process on the one card."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANKS_DEADLINE_S))
    try:
        from metrics_tpu_torch.core import MetricCollection
        from metrics_tpu_torch.core.state import CatBuffer
        from metrics_tpu_torch.ops.histogram import histogram_cuda
        from metrics_tpu_torch.ops.segment import segment_scan_cuda
        from metrics_tpu_torch.retrieval import RetrievalMAP

        collection = MetricCollection(collection_metrics("cuda"))
        check_groups(collection)
        maps = {"list": RetrievalMAP(), "cat_capacity": RetrievalMAP(cat_capacity=CAT_CAPACITY)}
        batches = rank_cityscapes_batches(torch, seed, rank)
        share = rank_msmarco_share(msmarco_batches(torch, seed), rank)
        torch.cuda.synchronize()
        histogram_cuda.launches = segment_scan_cuda.launches = 0  # ---- this rank's path starts
        t0 = time.perf_counter()
        for logits, target in batches:
            collection.update(logits, target)
        for preds, target, indexes in share:
            for metric in maps.values():
                metric.update(preds, target, indexes=indexes)
        torch.cuda.synchronize()
        update_s, compute_s = time.perf_counter() - t0, {}
        values = {}
        for name, metric in [*collection.items(keep_base=True, copy_state=False),
                             *((f"RetrievalMAP/{kind}", m) for kind, m in maps.items())]:
            t1 = time.perf_counter()
            values[name] = synced_compute(torch, metric)
            torch.cuda.synchronize()
            compute_s[name] = time.perf_counter() - t1
        launches = {"histogram": histogram_cuda.launches, "segment_scan": segment_scan_cuda.launches}
        # ---- this rank's path ends
        if not all(isinstance(getattr(maps["cat_capacity"], s), CatBuffer) for s in maps["cat_capacity"]._defaults):
            raise AssertionError("unsync did not restore the CatBuffer states")
        torch.save({"values": {k: v.cpu() for k, v in values.items()}, "launches": launches,
                    "rows": sum(b[0].numel() for b in share), "update_s": update_s, "compute_s": compute_s},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_sync_ranks(torch, seed: int, smi: str):
    """Four ranks on the one card in a gloo group: each feeds its own Cityscapes
    batches and MS MARCO share, syncs at ``compute``, and must equal one process
    run on the union of the data in rank order."""
    import shutil

    import torch.multiprocessing as mp

    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.retrieval import RetrievalMAP

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sync", f"ranks-{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    ctx = mp.start_processes(rank_main, args=(SYNC_RANKS, os.path.join(root, "store"), root, seed),
                             nprocs=SYNC_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {SYNC_RANKS} ranks did not finish within {RANKS_DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    ranks_s = time.perf_counter() - t0
    results = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(SYNC_RANKS)]
    shutil.rmtree(root, ignore_errors=True)

    # one process on the union, in rank order (not counted: it is the reference)
    union = MetricCollection(collection_metrics("cuda"))
    for rank in range(SYNC_RANKS):
        for logits, target in rank_cityscapes_batches(torch, seed, rank):
            union.update(logits, target)
    want = {name: v.cpu() for name, v in union.compute().items()}
    reference = RetrievalMAP()
    for preds, target, indexes in msmarco_batches(torch, seed):
        reference.update(preds, target, indexes=indexes)
    want["RetrievalMAP"] = reference.compute().cpu()

    worst, bit_equal = 0.0, True
    for rank, result in enumerate(results):
        got = result["values"]
        if not torch.equal(got["RetrievalMAP/list"], got["RetrievalMAP/cat_capacity"]):
            raise AssertionError(f"rank {rank}: RetrievalMAP of list and cat_capacity states differ")
        for name, value in want.items():
            mine = got[name if name in got else f"{name}/list"]
            if not value.is_floating_point():
                if mine.dtype != value.dtype or not torch.equal(mine, value):
                    raise AssertionError(f"rank {rank}: {name} differs from the single-process run on the union")
                continue
            err = (mine.double() - value.double()).abs().max().item()
            worst, bit_equal = max(worst, err), bit_equal and torch.equal(mine, value)
            if err > 1e-6:
                raise AssertionError(f"rank {rank}: {name} {mine} vs {value} on the union")
    launches = {k: sum(r["launches"][k] for r in results) for k in ("histogram", "segment_scan")}
    expected = {"histogram": SYNC_RANKS * 2 * RANK_BATCHES, "segment_scan": SYNC_RANKS * 2}
    if launches != expected:
        raise AssertionError(f"the ranks' launches {launches} differ from {expected}")
    emit({"phase": "sync_ranks", "card": smi, "backend": "gloo", "world_size": SYNC_RANKS,
          "msmarco_rows_per_rank": [r["rows"] for r in results], "launches": launches,
          "max_abs_err_vs_union": worst, "bit_equal_to_union": bit_equal,
          "update_s_per_rank": [r["update_s"] for r in results],
          "synced_compute_s_per_rank": [r["compute_s"] for r in results], "seconds_incl_spawn": ranks_s})
    return launches


# ----------------------------------------------------------------- classification_rest

# MS-COCO 2014 val as a multilabel evaluation: 40,504 images x 80 labels, ~2.9 labels per image
COCO = {"images": 40_504, "labels": 80, "positives_per_image": 2.9, "positive_shift": 1.5, "batch": 1_024}
# FairFace validation: 10,954 faces in 7 race groups (its published shares), a binary gender prediction
FAIRFACE = {"faces": 10_954, "group_shares": (0.19, 0.15, 0.14, 0.14, 0.14, 0.13, 0.11), "batch": 1_024}
CALIBRATION_BINS = 15
FIXED_POINTS = {"recall_at_precision": 0.5, "precision_at_recall": 0.5, "specificity_at_sensitivity": 0.9}


def jax_linspace_boundaries(torch, n_bins: int, device):
    """The float32 values of ``jnp.linspace(0, 1, n_bins + 1)``: i times the float32
    reciprocal of n_bins, then 1.0 (computed here with numpy, apart from the port)."""
    import numpy as np

    step = np.float32(1.0) / np.float32(n_bins)
    values = np.append(np.arange(n_bins, dtype=np.float32) * step, np.float32(1.0)).astype(np.float32)
    return torch.from_numpy(values).to(device)


def calibration_reference(torch, conf, correct, n_bins: int):
    """float64 ECE and MCE of float32 confidences, bucketed on the float32 boundaries."""
    bounds = jax_linspace_boundaries(torch, n_bins, conf.device).double()
    ids = (torch.searchsorted(bounds, conf.double().contiguous(), right=True) - 1).clamp(0, n_bins)
    zeros = torch.zeros(n_bins + 1, dtype=torch.float64, device=conf.device)
    count = zeros.index_add(0, ids, torch.ones_like(conf, dtype=torch.float64))
    conf_bin = zeros.index_add(0, ids, conf.double()) / count.clamp_min(1)
    acc_bin = zeros.index_add(0, ids, correct.double()) / count.clamp_min(1)
    gap = (acc_bin - conf_bin).abs()
    return float((gap * count / conf.numel()).sum()), float(gap.max())


def curve_reference(torch, scores, target):
    """float64 exact curves of the columns of ``scores`` (N, K) against binary ``target``:
    descending keys, run-end mask, cumulative tps/fps and the totals."""
    keys, order = torch.sort(scores.double(), dim=0, descending=True)
    pos = torch.gather(target.to(torch.int64), 0, order)
    tps = torch.cumsum(pos, 0)
    fps = torch.cumsum(1 - pos, 0)
    end = torch.ones_like(keys, dtype=torch.bool)
    end[:-1] = keys[1:] != keys[:-1]
    return {"keys": keys, "end": end, "tps": tps.double(), "fps": fps.double(),
            "pos": tps[-1].double(), "neg": fps[-1].double()}


def fixed_point_values(torch, ref, kind: str, bound: float):
    """Per column: (primary, secondary) in float64 at every row, and the qualifying mask."""
    t, f, p, q = ref["tps"], ref["fps"], ref["pos"], ref["neg"]
    precision, recall = t / (t + f), t / p
    if kind == "recall_at_precision":
        primary, secondary = recall, precision
    elif kind == "precision_at_recall":
        primary, secondary = precision, recall
    else:
        primary, secondary = 1 - f / q, recall
    return primary, ref["end"] & (secondary >= bound)


def check_fixed_points(torch, label: str, ref, kind: str, bound: float, got, tol: float = 1e-6) -> float:
    """The port's fixed points (value, threshold per column) against float64: the value
    within ``tol`` of the best qualifying float64 value, and the port's threshold a
    qualifying curve point whose float64 value is within ``tol`` of that best too."""
    value, threshold = (g.reshape(-1).double() for g in got)
    primary, ok = fixed_point_values(torch, ref, kind, bound)
    best = torch.where(ok, primary, float("-inf")).amax(0)
    best = torch.where(ok.any(0), best, 0.0)
    at = ok & (ref["keys"] == threshold[None, :])
    at_value = torch.where(at, primary, float("-inf")).amax(0)
    err = (value - best).abs().max().item()
    placed = ok.any(0) & (best != 0)  # a best of 0 pins the threshold to 1e6
    if err > tol or not bool(at.any(0)[placed].all()) or (at_value - best)[placed].abs().max().item() > tol:
        raise AssertionError(f"{label}: fixed point off the float64 curve by {err} (or its threshold)")
    return err


def metric_timing(torch, make, batch, metric, update_reps: int = 10, compute_reps: int = 3):
    """CUDA-event medians of one update of a fresh metric on ``batch`` and of ``metric``'s compute."""
    fresh = make()

    def compute():
        metric._computed = None  # time the computation, not the cached value
        metric.compute()

    return {"update_ms": event_ms(torch, lambda: fresh.update(*batch), reps=update_reps),
            "compute_ms": event_ms(torch, compute, reps=compute_reps, warmup=1)}


def histogram_mode_timing(torch, ids, weights, bins: int, library_weights):
    """The histogram kernel in one mode against the plain version, ``torch.bincount`` and the bound."""
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    got = histogram_cuda(ids, weights, bins)
    want = _plain_bincount(ids, weights if weights is None or weights.dtype == torch.bool else weights.double(), bins)
    if weights is None or weights.dtype == torch.bool:
        if not torch.equal(got, want):
            raise AssertionError(f"histogram kernel != plain in {'count' if weights is None else 'mask'} mode")
        max_abs_err = 0.0
    else:
        scale = _plain_bincount(ids, weights.abs().double(), bins)
        max_abs_err = (got.double() - want).abs().max().item()
        if not bool(torch.all((got.double() - want).abs() <= 1e-5 * scale)):
            raise AssertionError(f"histogram kernel f32 mode off by {max_abs_err}")
    n = ids.numel()
    per_row = ids.element_size() + (0 if weights is None else weights.element_size())
    bound_ms = (n * per_row + bins * 4) / HBM_BYTES_PER_S * 1e3
    call = lambda: histogram_cuda(ids, weights, bins)  # noqa: E731
    lib = lambda: torch.bincount(ids, weights=library_weights, minlength=bins)  # noqa: E731
    dev = sum(v for k, v in device_ms(torch, call).items() if "histogram" in k)
    return {"n": n, "bins": bins, "kernel_ms": event_ms(torch, call, warmup=10),
            "kernel_ms_back_to_back": back_to_back_ms(torch, call), "device_ms": dev,
            "plain_ms": event_ms(torch, lambda: _plain_bincount(ids, weights, bins), reps=3, warmup=1),
            "torch_bincount_ms": event_ms(torch, lib, reps=5, warmup=2), "bound_ms": bound_ms,
            "kernel_share_of_bound": bound_ms / dev if dev else None, "max_abs_err": max_abs_err}


def run_counted(torch, fn):
    """``fn()`` with both launch counts set to 0 just before and read just after."""
    from metrics_tpu_torch.ops.histogram import histogram_cuda
    from metrics_tpu_torch.ops.segment import segment_scan_cuda

    torch.cuda.synchronize()
    histogram_cuda.launches = segment_scan_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {"histogram": histogram_cuda.launches, "segment_scan": segment_scan_cuda.launches}, seconds


def expect_launches(label: str, got: dict, histogram: int, scan: int) -> None:
    if got != {"histogram": histogram, "segment_scan": scan}:
        raise AssertionError(f"{label}: launches {got}, expected {histogram} histogram and {scan} scan")


def rest_dlrm(torch, seed: int, smi: str):
    """Criteo day 23: calibration (l1 with cat_capacity, max with list states) and the three fixed points."""
    from metrics_tpu_torch.classification import (
        BinaryCalibrationError,
        BinaryPrecisionAtFixedRecall,
        BinaryRecallAtFixedPrecision,
        BinarySpecificityAtSensitivity,
    )

    scores, target = dlrm_data(torch, seed)
    n = scores.numel()
    batches = dlrm_batches(scores, target, n)
    makers = {
        "BinaryCalibrationError(l1, cat_capacity=2**27)":
            lambda: BinaryCalibrationError(n_bins=CALIBRATION_BINS, norm="l1", cat_capacity=1 << 27),
        "BinaryCalibrationError(max)": lambda: BinaryCalibrationError(n_bins=CALIBRATION_BINS, norm="max"),
        "BinaryRecallAtFixedPrecision(0.5)": lambda: BinaryRecallAtFixedPrecision(FIXED_POINTS["recall_at_precision"]),
        "BinaryPrecisionAtFixedRecall(0.5)": lambda: BinaryPrecisionAtFixedRecall(FIXED_POINTS["precision_at_recall"]),
        "BinarySpecificityAtSensitivity(0.9)":
            lambda: BinarySpecificityAtSensitivity(FIXED_POINTS["specificity_at_sensitivity"]),
    }
    metrics = {name: make() for name, make in makers.items()}

    def drive():
        for preds, labels in batches:
            for metric in metrics.values():
                metric.update(preds, labels)
        return {name: metric.compute() for name, metric in metrics.items()}

    values, launches, seconds = run_counted(torch, drive)
    expect_launches("DLRM", launches, 2 * 3, 3)

    errors = {}
    ece, mce = calibration_reference(torch, scores, target, CALIBRATION_BINS)
    for name, want in (("BinaryCalibrationError(l1, cat_capacity=2**27)", ece), ("BinaryCalibrationError(max)", mce)):
        errors[name] = abs(values[name].item() - want)
        if errors[name] > 1e-5:
            raise AssertionError(f"{name}: {values[name].item()} vs float64 {want}")
    ref = curve_reference(torch, scores[:, None], target[:, None])
    for (name, kind) in zip(list(makers)[2:], FIXED_POINTS):
        errors[name] = check_fixed_points(torch, f"DLRM {name}", ref, kind, FIXED_POINTS[kind], values[name])
    del ref

    # the histogram kernel in the calibration's f32 and mask modes, on its own inputs (16 bins)
    bounds = jax_linspace_boundaries(torch, CALIBRATION_BINS, "cuda")
    ids = (torch.searchsorted(bounds, scores, right=True) - 1).clamp(0, CALIBRATION_BINS).to(torch.int32)
    correct = target != 0
    modes = {"f32": histogram_mode_timing(torch, ids, scores, CALIBRATION_BINS + 1, scores),
             "mask": histogram_mode_timing(torch, ids, correct, CALIBRATION_BINS + 1, correct.float())}
    timing = {name: metric_timing(torch, makers[name], batches[0], metrics[name]) for name in makers}
    emit({"phase": "classification_rest", "config": "dlrm_criteo_day23", "card": smi, "samples": n,
          "updates": len(batches), "values": {k: [v.item() for v in vs] if isinstance(vs, tuple) else vs.item()
                                              for k, vs in values.items()},
          "float64_reference": {"ece": ece, "mce": mce}, "abs_err_vs_float64": errors, "max_abs_err": max(errors.values()),
          "launches": launches, "seconds_incl_updates": seconds, "timing": timing, "histogram_modes": modes})
    return launches


def rest_imagenet(torch, seed: int, smi: str):
    """ImageNet-1k validation: 15-bin ECE, Crammer-Singer hinge, recall at precision 0.5 per class."""
    from metrics_tpu_torch.classification import (
        MulticlassCalibrationError,
        MulticlassHingeLoss,
        MulticlassRecallAtFixedPrecision,
    )

    gi = torch.Generator(device="cuda").manual_seed(seed + 3)
    c, m, b = IMAGENET["classes"], IMAGENET["samples"], IMAGENET["batch"]
    probs = torch.softmax(2.0 * torch.randn((m, c), generator=gi, device="cuda"), dim=1)
    labels = torch.randint(0, c, (m,), generator=gi, device="cuda")
    makers = {
        "MulticlassCalibrationError(1000, l1)": lambda: MulticlassCalibrationError(c, n_bins=CALIBRATION_BINS),
        "MulticlassHingeLoss(1000)": lambda: MulticlassHingeLoss(c),
        "MulticlassRecallAtFixedPrecision(1000, 0.5)": lambda: MulticlassRecallAtFixedPrecision(c, 0.5),
    }
    metrics = {name: make() for name, make in makers.items()}
    batches = [(probs[s:s + b], labels[s:s + b]) for s in range(0, m, b)]

    def drive():
        for preds, target in batches:
            for metric in metrics.values():
                metric.update(preds, target)
        return {name: metric.compute() for name, metric in metrics.items()}

    values, launches, seconds = run_counted(torch, drive)
    expect_launches("ImageNet", launches, 3, c)
    conf, pred = probs.max(dim=1)
    errors = {}
    ece, _ = calibration_reference(torch, conf, pred == labels, CALIBRATION_BINS)
    errors["MulticlassCalibrationError(1000, l1)"] = abs(values["MulticlassCalibrationError(1000, l1)"].item() - ece)
    true_score = probs.double().gather(1, labels[:, None])[:, 0]
    other = probs.double().scatter(1, labels[:, None], float("-inf")).amax(1)
    hinge = (1 - (true_score - other)).clamp_min(0).mean().item()
    errors["MulticlassHingeLoss(1000)"] = abs(values["MulticlassHingeLoss(1000)"].item() - hinge)
    for name, err in errors.items():
        if err > 1e-5:
            raise AssertionError(f"ImageNet {name}: off float64 by {err}")
    onehot = torch.nn.functional.one_hot(labels, c)
    ref = curve_reference(torch, probs, onehot)
    name = "MulticlassRecallAtFixedPrecision(1000, 0.5)"
    errors[name] = check_fixed_points(torch, f"ImageNet {name}", ref, "recall_at_precision", 0.5, values[name])
    del ref, onehot
    timing = {name: metric_timing(torch, makers[name], batches[0], metrics[name], compute_reps=2) for name in makers}
    emit({"phase": "classification_rest", "config": "imagenet_val", "card": smi, "samples": m, "classes": c,
          "values": {"ece": values["MulticlassCalibrationError(1000, l1)"].item(),
                     "hinge": values["MulticlassHingeLoss(1000)"].item(),
                     "recall_at_precision_mean": values[name][0].mean().item()},
          "float64_reference": {"ece": ece, "hinge": hinge}, "abs_err_vs_float64": errors,
          "max_abs_err": max(errors.values()), "launches": launches,
          "seconds_incl_updates": seconds, "timing": timing})
    return launches


def coco_data(torch, seed: int):
    """MS-COCO 2014 val shaped multilabel scores, drawn on the card, rounded through bfloat16."""
    c = COCO
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    n, k = c["images"], c["labels"]
    target = (torch.rand((n, k), generator=g, device="cuda") < c["positives_per_image"] / k).long()
    z = torch.randn((n, k), generator=g, device="cuda") + c["positive_shift"] * target
    return torch.sigmoid(z).to(torch.bfloat16).to(torch.float32), target


def ranking_reference(torch, scores, target):
    """float64 per-sample coverage error, label-ranking AP and ranking loss (ties as the
    JAX package resolves them: rank = labels scored at least as high; ranking loss over
    the stable ascending order), averaged over the samples."""
    s, rel = scores.double(), target == 1
    k = s.shape[1]
    n_rel = rel.sum(1)
    lowest_rel = torch.where(rel, s, float("inf")).amin(1)
    coverage = torch.where(n_rel > 0, (s >= lowest_rel[:, None]).sum(1).double(), 0.0)
    ge = s[:, None, :] >= s[:, :, None]  # ge[i, j, l]: label l scores at least as high as j
    rank_all = ge.sum(2).double()
    rank_rel = (ge & rel[:, None, :]).sum(2).double()
    per = torch.where(rel, rank_rel / rank_all, 0.0).sum(1) / n_rel.clamp_min(1)
    lrap = torch.where((n_rel > 0) & (n_rel < k), per, 1.0)
    idx = torch.arange(k, device=s.device)
    after = (s[:, None, :] > s[:, :, None]) | ((s[:, None, :] == s[:, :, None]) & (idx[None, :] > idx[:, None]))
    wrong = (after & rel[:, :, None] & ~rel[:, None, :]).sum((1, 2)).double()
    loss = torch.where((n_rel > 0) & (n_rel < k), wrong / (n_rel * (k - n_rel)).clamp_min(1), 0.0)
    return {"MultilabelCoverageError": coverage.mean().item(), "MultilabelRankingAveragePrecision": lrap.mean().item(),
            "MultilabelRankingLoss": loss.mean().item()}


def rest_coco(torch, seed: int, smi: str):
    from metrics_tpu_torch.classification import (
        MultilabelCoverageError,
        MultilabelPrecisionAtFixedRecall,
        MultilabelRankingAveragePrecision,
        MultilabelRankingLoss,
        MultilabelSpecificityAtSensitivity,
    )

    scores, target = coco_data(torch, seed)
    k, b = COCO["labels"], COCO["batch"]
    makers = {
        "MultilabelCoverageError": lambda: MultilabelCoverageError(k),
        "MultilabelRankingAveragePrecision": lambda: MultilabelRankingAveragePrecision(k),
        "MultilabelRankingLoss": lambda: MultilabelRankingLoss(k),
        "MultilabelPrecisionAtFixedRecall(80, 0.5)": lambda: MultilabelPrecisionAtFixedRecall(k, 0.5),
        "MultilabelSpecificityAtSensitivity(80, 0.5)": lambda: MultilabelSpecificityAtSensitivity(k, 0.5),
    }
    metrics = {name: make() for name, make in makers.items()}
    batches = [(scores[s:s + b], target[s:s + b]) for s in range(0, scores.shape[0], b)]

    def drive():
        for preds, labels in batches:
            for metric in metrics.values():
                metric.update(preds, labels)
        return {name: metric.compute() for name, metric in metrics.items()}

    values, launches, seconds = run_counted(torch, drive)
    expect_launches("COCO", launches, 0, 2 * k)
    refs = ranking_reference(torch, scores, target)
    errors = {name: abs(values[name].item() - want) for name, want in refs.items()}
    for name, err in errors.items():
        if err > 1e-6:
            raise AssertionError(f"COCO {name}: {values[name].item()} vs float64 {refs[name]}")
    ref = curve_reference(torch, scores, target)
    for name, kind in (("MultilabelPrecisionAtFixedRecall(80, 0.5)", "precision_at_recall"),
                       ("MultilabelSpecificityAtSensitivity(80, 0.5)", "specificity_at_sensitivity")):
        errors[name] = check_fixed_points(torch, f"COCO {name}", ref, kind, 0.5, values[name])
    del ref
    timing = {name: metric_timing(torch, makers[name], batches[0], metrics[name]) for name in makers}
    emit({"phase": "classification_rest", "config": "coco2014_val_multilabel", "card": smi,
          "images": scores.shape[0], "labels": k, "positives_per_image": target.sum().item() / scores.shape[0],
          "values": {name: values[name].item() for name in refs}, "float64_reference": refs,
          "abs_err_vs_float64": errors, "max_abs_err": max(errors.values()), "launches": launches,
          "seconds_incl_updates": seconds, "timing": timing})
    return launches


def rest_fairface(torch, seed: int, smi: str):
    from metrics_tpu_torch.classification import BinaryFairness
    from metrics_tpu_torch.ops.histogram import _plain_bincount

    f = FAIRFACE
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    n, shares = f["faces"], torch.tensor(f["group_shares"], device="cuda")
    groups = torch.multinomial(shares, n, replacement=True, generator=g)
    gender = (torch.rand(n, generator=g, device="cuda") < 0.53).long()
    # a gender classifier whose margin varies with the group (the disparity the metric reads)
    shift = torch.linspace(1.0, 2.0, len(f["group_shares"]), device="cuda")[groups]
    scores = torch.sigmoid(torch.randn(n, generator=g, device="cuda") + shift * (2 * gender - 1))
    metric = BinaryFairness(len(f["group_shares"]), task="all")
    b = f["batch"]
    batches = [(scores[s:s + b], gender[s:s + b], groups[s:s + b]) for s in range(0, n, b)]

    def drive():
        for batch in batches:
            metric.update(*batch)
        return metric.compute()

    value, launches, seconds = run_counted(torch, drive)
    expect_launches("FairFace", launches, len(batches), 0)
    k = len(f["group_shares"])
    ids = (groups * 4 + 2 * gender + (scores > 0.5).long()).to(torch.int32)
    bins = _plain_bincount(ids, None, 4 * k).reshape(k, 4).long()
    want = {"tn": bins[:, 0], "fp": bins[:, 1], "fn": bins[:, 2], "tp": bins[:, 3]}
    for name, counts in want.items():
        if not torch.equal(getattr(metric, name), counts):
            raise AssertionError(f"FairFace {name} counts differ from the plain histogram")
    mode = histogram_mode_timing(torch, ids, None, 4 * k, None)
    emit({"phase": "classification_rest", "config": "fairface_val", "card": smi, "faces": n, "groups": k,
          "values": {key: v.item() for key, v in value.items()}, "counts_bit_equal_to_plain": True, "max_abs_err": 0,
          "launches": launches, "seconds_incl_updates": seconds,
          "timing": metric_timing(torch, lambda: BinaryFairness(k, task="all"), batches[0], metric),
          "histogram_count_mode": mode})
    return launches


def rest_cityscapes_dice(torch, seed: int, smi: str):
    """Dice on one Cityscapes batch of (N, C, H, W) logits. The legacy class refuses
    ``ignore_index=255`` (it must lie below ``num_classes``) and a target label past the
    C axis, so the void label becomes a 20th class with a never-chosen logit, ignored
    through ``ignore_index=19``: micro Dice with ``mdmc_average="global"``."""
    from metrics_tpu_torch.classification import Dice
    from metrics_tpu_torch.ops.histogram import _plain_bincount

    c, ii = CITYSCAPES["classes"], CITYSCAPES["ignore_index"]
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    logits, target = cityscapes_batch(torch, g)
    void = torch.full_like(logits[:, :1], float("-inf"))
    logits = torch.cat([logits, void], 1)
    target = target.masked_fill(target == ii, c)
    del void
    metric = Dice(num_classes=c + 1, ignore_index=c, mdmc_average="global")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    value, launches, seconds = run_counted(torch, lambda: (metric.update(logits, target), metric.compute())[1])
    peak = torch.cuda.max_memory_allocated() - base
    expect_launches("Cityscapes Dice", launches, 0, 0)
    cm = _plain_bincount((target * (c + 1) + logits.argmax(1)).reshape(-1), None, (c + 1) ** 2)
    cm = cm.reshape(c + 1, c + 1).long()
    tp = cm[:c, :c].diagonal().sum()
    fp, fn = cm[:, :c].sum() - tp, cm[:c, :].sum() - tp
    want = (2 * tp).to(torch.float32) / (2 * tp + fp + fn).to(torch.float32)
    if not torch.equal(value, want):
        raise AssertionError(f"Dice {value.item()} vs 2tp/(2tp+fp+fn) {want.item()} from the confusion histogram")
    timing = metric_timing(torch, lambda: Dice(num_classes=c + 1, ignore_index=c, mdmc_average="global"),
                           (logits, target), metric, update_reps=3)
    emit({"phase": "classification_rest", "config": "cityscapes_dice", "card": smi,
          "predictions": target.numel(), "value": value.item(), "bit_equal_to_confusion_histogram": True, "max_abs_err": 0,
          "launches": launches, "seconds_incl_update": seconds, "update_peak_bytes": peak,
          "logits_bytes": logits.numel() * logits.element_size(), "timing": timing})
    return launches


def phase_classification_rest(torch, seed: int, smi: str):
    """The rest of classification at published widths: DLRM calibration and fixed points,
    ImageNet calibration/hinge/fixed points, COCO ranking and fixed points, FairFace
    fairness, Cityscapes Dice. Returns the launches of both kernels."""
    total = {"histogram": 0, "segment_scan": 0}
    t0 = time.perf_counter()
    dlrm = rest_dlrm(torch, seed, smi)
    torch.cuda.empty_cache()
    imagenet = rest_imagenet(torch, seed, smi)
    torch.cuda.empty_cache()
    coco = rest_coco(torch, seed, smi)
    fairface = rest_fairface(torch, seed, smi)
    dice = rest_cityscapes_dice(torch, seed, smi)
    torch.cuda.empty_cache()
    for launches in (dlrm, imagenet, coco, fairface, dice):
        for key in total:
            total[key] += launches[key]
    emit({"phase": "classification_rest", "config": "all", "launches": total,
          "seconds_incl_checks_and_timing": time.perf_counter() - t0})
    return total


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
    phase_segscan_kernel_vs_plain(torch, args.seed)
    gpu, batch, launches = phase_main_path(torch, args.seed)
    curve = phase_curve_path(torch, args.seed)
    kernels = phase_timing(torch, gpu, batch, launches, smi, args.seed)
    del gpu, batch
    scan = phase_curve_timing(torch, *curve, smi)
    del curve
    runs, batch, calls, retrieval_launches = phase_retrieval_path(torch, args.seed)
    phase_retrieval_timing(torch, runs, batch, calls, smi)
    map_value = runs["list"]["RetrievalMAP"].compute()
    del runs, batch, calls
    scan["launches"] += retrieval_launches
    kernels.append(scan)

    batches, collection_values, collection_launches = phase_collection(torch, args.seed, smi)
    nccl = phase_sync_nccl(torch, args.seed, batches, collection_values, map_value, smi)
    del batches
    ranks = phase_sync_ranks(torch, args.seed, smi)
    kernels[0]["launches"] += collection_launches + nccl["histogram"] + ranks["histogram"]
    scan["launches"] += nccl["segment_scan"] + ranks["segment_scan"]
    rest = phase_classification_rest(torch, args.seed, smi)
    kernels[0]["launches"] += rest["histogram"]
    scan["launches"] += rest["segment_scan"]

    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
