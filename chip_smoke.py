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

13. image: the image and pairwise slice, data drawn on the card, no hand kernel (both
    launch counts 0):
    - CIFAR-10 FID protocol: 50,000 real and 50,000 generated 3x32x32 uint8 images in
      updates of 500, resized to 299x299 inside a full-width InceptionV3 on
      ``random_inception_state(seed)``: FrechetInceptionDistance (tap 2048),
      KernelInceptionDistance (100 subsets of 1,000) and InceptionScore (10 splits,
      ``logits_unbiased``). Checks: 8 images' features on the card within 1e-3 of the
      port's CPU forward; FID within 1e-5 relative of float64 numpy (symmetrised eigh)
      on the same moments, and at the 768 tap (first 10,000 + 10,000 images) the numpy
      trace within 1e-6 of ``scipy.linalg.sqrtm``'s; KID and IS within 1e-5 relative of
      float64 numpy from the same features and draws. Timings: forward images/s (float32
      and bf16), update and compute ms, tr(sqrtm) three ways (float64 eigh on the card,
      float64 numpy on the host, float32 Newton-Schulz).
    - Pairwise: the first 4,096 real and fake features through the five functions,
      against float64 on the card; ms and peak memory of each.
    - DIV2K x4 validation shape: 100 images of 3x1356x2040 in updates of 4, preds =
      target + N(0, 0.05) clipped: SSIM, MS-SSIM, PSNR, PSNRB on the luma, UQI and TV
      (``data_range=1.0``) within 1e-5 of float64 runs on the card, and one image on the
      card against the port's CPU run; update and compute ms, the peak memory of an SSIM
      update, and its stack blurred four ways (the port's separable grouped conv, the
      11x11 product window, banded matmuls, the separable passes as one-channel convs).

14. detection: COCO 2017 val object detection drawn on the card (5,000 images of 640x480,
    36,781 gt boxes over the 80 category ids, areas ~41/34/25% small/medium/large, 100
    detections an image: jittered copies of 85% of the gts, false positives of random
    class and place, bf16 scores, 4% integer pairs at IoU exactly 0.5 or 0.75; boxes on
    quarter pixels; the 20 crowded images at random places):
    - MeanAveragePrecision(class_metrics=True) in the consolidated layout (50 updates of
      (100, 100, 4) boxes; 2 greedy-match launches a compute) and the list layout (the
      same images as per-image dicts; 1 launch), again on the first 1,000 (consolidated),
      200 and 500 images (list), segm on the first 100 images' top 20 detections as filled
      480x640 masks and bbox on the same whole-pixel boxes; exact launches per compute.
      Checks within 1e-6: consolidated against list, segm against bbox, the card against
      the port's CPU run (consolidated on 1,000 images, list on 200), the list run on 500
      images against a float64 numpy evaluator written here; classes equal.
    - the four IoU classes over the 5,000 images, within 1e-5 of float64 and 1e-6 of the
      CPU on 200 images;
    - PanopticQuality and ModifiedPanopticQuality at the COCO panoptic val2017 shape (133
      categories: 80 things, 53 stuffs) on 100 maps of 480x640 in updates of 10: one
      count-mode histogram launch per map, counts equal to the CPU run's, PQ within 1e-6;
    - the kernel bit-equal to its plain version on the COCO compute's small- and
      big-bucket inputs and on D or G = 1, G = 1024, groups without valid rows, ties, IoUs
      at a threshold and area-ignored gts; its event, device and back-to-back ms against
      the plain version and the bound (the IoU of valid (detection, gt) pairs, areas and
      masks read once, both masks and npig written once, at 3.35 TB/s) at both bucket
      shapes; update, compute and the list layout's host ``_build_groups`` ms; the
      consolidated compute's idle share (device busy over the same profiled call's wall).

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


# CIFAR-10 FID protocol (Heusel et al. 2017, as torch-fidelity and pytorch-fid run it):
# 50,000 real against 50,000 generated 3x32x32 uint8 images, resized to 299x299 inside
# the network, in updates of 500
CIFAR10 = {"real": 50_000, "fake": 50_000, "batch": 500, "size": 32}
KID_ARGS = {"subsets": 100, "subset_size": 1000}
IS_SPLITS = 10
FID_768_IMAGES = 10_000  # per set: the 768-tap FID of the scipy.linalg.sqrtm cross-check
FEATURE_CHECK_IMAGES = 8
FEATURE_ATOL = 1e-3
FID_REL = 1e-5  # FID, KID and IS against float64 numpy on the same moments, features and draws
# DIV2K x4 super-resolution validation: 100 RGB images; DIV2K's sizes vary around
# 2040 x 1356, here all 1356 x 2040; updates of 4, preds = target + N(0, 0.05) in [0, 1]
DIV2K = {"images": 100, "height": 1356, "width": 2040, "batch": 4, "noise": 0.05}
PAIRWISE_ROWS = 4_096


def cifar_batch(torch, g, n: int, fake: bool):
    """``n`` uint8 3x32x32 images on the card: smooth 8x8 colour fields, upsampled, plus
    pixel noise; the generated set is darker and noisier, so its FID is far from 0."""
    low = torch.rand((n, 3, 8, 8), generator=g, device="cuda")
    img = torch.nn.functional.interpolate(low, size=CIFAR10["size"], mode="bilinear", align_corners=False) * 255
    noise = torch.randn((n, 3, CIFAR10["size"], CIFAR10["size"]), generator=g, device="cuda")
    img = img * (0.85 if fake else 1.0) + noise * (24.0 if fake else 12.0)
    return img.clamp_(0, 255).to(torch.uint8)


def fid_numpy(metric):
    """FID in float64 numpy from ``metric``'s centered moments, through the symmetrised
    form tr(sqrtm(sqrtm(S1) S2 sqrtm(S1))); returns (fid, S1, S2, trace of the root)."""
    import numpy as np

    mean1, m2_1, n1, mean2, m2_2, n2 = (
        getattr(metric, name).double().cpu().numpy()
        for name in ("real_mean", "real_m2", "real_features_num_samples",
                     "fake_mean", "fake_m2", "fake_features_num_samples")
    )
    s1, s2 = m2_1 / (float(n1) - 1), m2_2 / (float(n2) - 1)
    vals, vecs = np.linalg.eigh(s1)
    half = (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T
    tr = np.sqrt(np.clip(np.linalg.eigvalsh(half @ s2 @ half), 0, None)).sum()
    diff = mean1 - mean2
    return diff @ diff + np.trace(s1) + np.trace(s2) - 2 * tr, s1, s2, tr


def kid_numpy(real, fake, idx_real, idx_fake):
    """KID (mean, std) in float64 numpy over the given subsets (degree 3, gamma 1/d, coef 1)."""
    import numpy as np

    scores = []
    for ir, if_ in zip(idx_real, idx_fake):
        x, y = real[ir], fake[if_]
        m, gamma = x.shape[0], 1.0 / x.shape[1]
        k_xx, k_yy, k_xy = ((a @ b.T * gamma + 1.0) ** 3 for a, b in ((x, x), (y, y), (x, y)))
        value = (k_xx.sum() - np.trace(k_xx) + k_yy.sum() - np.trace(k_yy)) / (m * (m - 1))
        scores.append(value - 2 * k_xy.sum() / m**2)
    scores = np.asarray(scores)
    return scores.mean(), scores.std(ddof=1)


def is_numpy(logits, perm, splits: int):
    """IS (mean, std over splits of the mean KL) in float64 numpy, as the JAX package computes it."""
    import numpy as np

    logits = logits[perm]
    shifted = logits - logits.max(1, keepdims=True)
    log_prob = shifted - np.log(np.exp(shifted).sum(1, keepdims=True))
    prob = np.exp(log_prob)
    kls = []
    for p, log_p in zip(np.array_split(prob, splits), np.array_split(log_prob, splits)):
        kls.append((p * (log_p - np.log(p.mean(0, keepdims=True)))).sum(1).mean())
    kls = np.asarray(kls)
    return kls.mean(), kls.std(ddof=1)


def events_ms(torch, pairs) -> list:
    """Elapsed ms of each recorded (start, end) CUDA event pair."""
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


def timed_call(torch, pairs: list, fn):
    """``fn()`` between two recorded CUDA events appended to ``pairs`` (no synchronisation)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    pairs.append((start, end))
    return out


KERNEL_GROUPS = (  # substrings of kernel names, lower case, first match wins
    ("convolution_and_matmul", ("conv", "xmma", "cudnn", "gemm", "cutlass", "implicit")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("concatenation", ("cat",)),
    ("copy_and_fill", ("copy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_groups(torch, fn, reps: int = 2) -> dict:
    """Device ms per ``fn()`` call from a profiler trace: the busy total, the time of each
    kernel group of KERNEL_GROUPS, and the five longest kernels."""
    return group_kernels(device_ms(torch, fn, reps=reps))


def group_kernels(kernels: dict) -> dict:
    """The busy total of a {kernel: ms} profile, its ms by KERNEL_GROUPS and its five
    longest kernels."""
    groups = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": sum(kernels.values()), "groups": groups, "top": top}


def compute_timing(torch, metric, reps: int = 3) -> dict:
    """``metric.compute()`` in ms: the first timed call, and the median of the next ``reps``."""
    times = []
    for _ in range(reps + 1):
        metric._computed = None  # time the computation, not the cached value
        pairs = []
        timed_call(torch, pairs, metric.compute)
        times.append(events_ms(torch, pairs)[0])
    return {"first_ms": times[0], "ms": statistics.median(times[1:])}


def image_inception_metrics(torch, seed: int, smi: str):
    """FID, KID and IS by the CIFAR-10 protocol on a full-width InceptionV3 with seeded
    random weights; returns the first PAIRWISE_ROWS real and fake 2048-d features."""
    import numpy as np
    import scipy.linalg

    from metrics_tpu_torch.functional.image.fid_math import _sqrtm_trace_eigh, _sqrtm_trace_newton_schulz
    from metrics_tpu_torch.image import FrechetInceptionDistance, InceptionScore, KernelInceptionDistance
    from metrics_tpu_torch.models.inception import FeatureExtractorInceptionV3, random_inception_state
    from metrics_tpu_torch.utils.compute import fp32_exact
    from metrics_tpu_torch.utils.data import dim_zero_cat

    state = random_inception_state(seed)
    net = FeatureExtractorInceptionV3(2048, state=state)
    logits_net = FeatureExtractorInceptionV3("logits_unbiased", state=state)
    net768 = FeatureExtractorInceptionV3(768, state=state)
    fid, fid768 = FrechetInceptionDistance(feature=net), FrechetInceptionDistance(feature=net768)
    kid = KernelInceptionDistance(feature=net, **KID_ARGS)
    inception = InceptionScore(feature=logits_net, splits=IS_SPLITS)

    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    batch = CIFAR10["batch"]
    pairs = {"fid": [], "kid": [], "is": []}
    t0 = time.perf_counter()
    for i in range(CIFAR10["real"] // batch):
        real, fake = cifar_batch(torch, g, batch, fake=False), cifar_batch(torch, g, batch, fake=True)
        if i == 0:
            check_images = real[:FEATURE_CHECK_IMAGES].clone()
        timed_call(torch, pairs["fid"], lambda: (fid.update(real, real=True), fid.update(fake, real=False)))
        timed_call(torch, pairs["kid"], lambda: (kid.update(real, real=True), kid.update(fake, real=False)))
        timed_call(torch, pairs["is"], lambda: inception.update(fake))
        if (i + 1) * batch <= FID_768_IMAGES:
            fid768.update(real, real=True)
            fid768.update(fake, real=False)
    update_ms = {name: statistics.median(events_ms(torch, p)) for name, p in pairs.items()}
    loop_seconds = time.perf_counter() - t0

    # the forward on the card against the port's CPU forward of the same images
    cpu_net = FeatureExtractorInceptionV3(2048, state=state, device="cpu")
    feature_err = {}
    for tap in (2048, "logits_unbiased"):
        got = net(check_images, tap).cpu()
        feature_err[str(tap)] = (got - cpu_net(check_images.cpu(), tap)).abs().max().item()
        if feature_err[str(tap)] > FEATURE_ATOL:
            raise AssertionError(f"Inception tap {tap}: card vs CPU {feature_err[str(tap)]} > {FEATURE_ATOL}")
    bf16_net = FeatureExtractorInceptionV3(2048, state=state, compute_dtype=torch.bfloat16)
    f32_features = net(check_images)
    bf16_rel = ((bf16_net(check_images) - f32_features).abs().max() / f32_features.abs().max()).item()
    forward = {}
    timing_batch = cifar_batch(torch, g, batch, fake=False)
    for name, model in (("f32", net), ("bf16", bf16_net)):
        ms = event_ms(torch, lambda: model(timing_batch), reps=5, warmup=2)
        forward[name] = {"ms_per_500": ms, "images_per_s": batch / ms * 1e3}
    # the same forwards with cuDNN's autotuner and channels-last layouts (not the port's path)
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for name, model in (("f32", net), ("bf16", bf16_net)):
            ms = event_ms(torch, lambda: model(timing_batch), reps=5, warmup=2)
            forward[name + "_cudnn_benchmark"] = {"ms_per_500": ms, "images_per_s": batch / ms * 1e3}
            model.to(memory_format=torch.channels_last)
            last = timing_batch.contiguous(memory_format=torch.channels_last)
            ms = event_ms(torch, lambda: model(last), reps=5, warmup=2)
            forward[name + "_cudnn_benchmark_channels_last"] = {"ms_per_500": ms, "images_per_s": batch / ms * 1e3}
            model.to(memory_format=torch.contiguous_format)
    finally:
        torch.backends.cudnn.benchmark = saved

    fresh = FrechetInceptionDistance(feature=net)
    fid_update_profile = profile_groups(torch, lambda: fresh.update(timing_batch, real=True))
    del fresh

    # FID on the card (float64 eigh on the device) against float64 numpy on the same moments
    fid_value = fid.compute().item()
    fid_timing = compute_timing(torch, fid)
    t1 = time.perf_counter()
    ref, s1, s2, tr_ref = fid_numpy(fid)
    host_ms = (time.perf_counter() - t1) * 1e3
    if not abs(fid_value - ref) <= FID_REL * abs(ref):
        raise AssertionError(f"FID {fid_value} vs float64 numpy {ref}")
    s1_d, s2_d = torch.from_numpy(s1).cuda(), torch.from_numpy(s2).cuda()
    sqrtm = {"host_numpy_f64": {"ms_incl_copy": host_ms, "trace_rel_err": 0.0}}
    tr = _sqrtm_trace_eigh(s1_d, s2_d).item()
    sqrtm["device_eigh_f64"] = {"ms": event_ms(torch, lambda: _sqrtm_trace_eigh(s1_d, s2_d), reps=3, warmup=1),
                                "trace_rel_err": abs(tr - tr_ref) / tr_ref}
    s1_f, s2_f = s1_d.float(), s2_d.float()

    def newton_schulz():
        with fp32_exact():
            return _sqrtm_trace_newton_schulz(s1_f @ s2_f)

    tr = newton_schulz().item()
    sqrtm["device_newton_schulz_f32"] = {"ms": event_ms(torch, newton_schulz, reps=3, warmup=1),
                                         "trace_rel_err": abs(tr - tr_ref) / tr_ref,
                                         "fid_rel_err": abs(2 * (tr - tr_ref)) / abs(ref)}
    del s1_d, s2_d, s1_f, s2_f

    # the 768 tap: card, numpy eigh, and scipy.linalg.sqrtm of S1 S2 as a cross-check. A
    # feature constant over a set (a dead channel of the random network) makes its
    # covariance singular; S1 S2 keeps its nonzero spectrum without those features, so
    # sqrtm runs on the others
    ref768, s1, s2, tr768 = fid_numpy(fid768)
    live = (np.diag(s1) > 0) & (np.diag(s2) > 0)
    scipy_tr = float(np.trace(scipy.linalg.sqrtm(s1[live][:, live] @ s2[live][:, live])).real)
    fid768_value = fid768.compute().item()
    if not (abs(fid768_value - ref768) <= FID_REL * abs(ref768) and abs(scipy_tr - tr768) <= 1e-6 * tr768):
        raise AssertionError(f"768 tap: FID {fid768_value} vs {ref768}; trace {tr768} vs scipy {scipy_tr}")

    # KID and IS against float64 numpy from the same features and draws
    real_features, fake_features = dim_zero_cat(kid.real_features), dim_zero_cat(kid.fake_features)
    np.random.seed(seed)
    kid_mean, kid_std = (v.item() for v in kid.compute())
    kid_timing = compute_timing(torch, kid)
    np.random.seed(seed)
    rng = np.random.default_rng(np.random.randint(0, 2**31))
    n_real, n_fake, size = real_features.shape[0], fake_features.shape[0], KID_ARGS["subset_size"]
    idx_real = [rng.permutation(n_real)[:size] for _ in range(KID_ARGS["subsets"])]
    idx_fake = [rng.permutation(n_fake)[:size] for _ in range(KID_ARGS["subsets"])]
    t1 = time.perf_counter()
    kid_ref = kid_numpy(real_features.double().cpu().numpy(), fake_features.double().cpu().numpy(), idx_real, idx_fake)
    kid_numpy_s = time.perf_counter() - t1
    kid_err = max(abs(kid_mean - kid_ref[0]) / abs(kid_ref[0]), abs(kid_std - kid_ref[1]) / abs(kid_ref[1]))
    if not kid_err <= FID_REL:
        raise AssertionError(f"KID ({kid_mean}, {kid_std}) vs float64 {kid_ref}")
    np.random.seed(seed + 1)
    is_mean, is_std = (v.item() for v in inception.compute())
    is_timing = compute_timing(torch, inception)
    np.random.seed(seed + 1)
    logits = dim_zero_cat(inception.features).double().cpu().numpy()
    is_ref = is_numpy(logits, np.random.permutation(logits.shape[0]), IS_SPLITS)
    is_err = max(abs(is_mean - is_ref[0]) / abs(is_ref[0]), abs(is_std - is_ref[1]) / abs(is_ref[1]))
    if not is_err <= FID_REL:
        raise AssertionError(f"IS ({is_mean}, {is_std}) vs float64 {is_ref}")

    emit({"phase": "image", "config": "cifar10_fid_kid_is", "card": smi, "network": "InceptionV3 full width,"
          " random_inception_state(seed)", "images": [CIFAR10["real"], CIFAR10["fake"]], "batch": batch,
          "loop_seconds": loop_seconds, "update_ms": update_ms, "forward": forward,
          "fid_update_500_profile": fid_update_profile,
          "feature_card_vs_cpu_max_abs_err": feature_err, "bf16_vs_f32_rel": bf16_rel,
          "fid": fid_value, "fid_float64_numpy": ref, "fid_compute": fid_timing, "sqrtm_2048": sqrtm,
          "fid768": fid768_value, "fid768_float64_numpy": ref768, "trace768_scipy_rel": abs(scipy_tr - tr768) / tr768,
          "features768_live": int(live.sum()),
          "kid": [kid_mean, kid_std], "kid_float64_numpy": list(kid_ref), "kid_max_rel_err": kid_err,
          "kid_compute": kid_timing, "kid_numpy_seconds": kid_numpy_s,
          "is": [is_mean, is_std], "is_float64_numpy": list(is_ref), "is_max_rel_err": is_err,
          "is_compute": is_timing})
    return real_features[:PAIRWISE_ROWS].clone(), fake_features[:PAIRWISE_ROWS].clone()


def image_pairwise(torch, x, y, smi: str) -> None:
    """The five pairwise functions on 4,096 x 4,096 2048-d features against float64 on the card."""
    from metrics_tpu_torch.functional import pairwise as tp

    out = {}
    sq_x, sq_y = x.double().square().sum(1), y.double().square().sum(1)
    for name in tp.__all__:
        fn = getattr(tp, name)
        got, want = fn(x, y).double(), fn(x.double(), y.double())
        err = (got - want).abs()
        if name == "pairwise_euclidean_distance":
            # |x|^2 + |y|^2 - 2 x.y: each float32 sum of d products rounds by ~sqrt(d) ulps
            # of its size, and the distance moves by at most the square root of that
            slack = 4 * x.shape[1] ** 0.5 * 2.0**-24 * (sq_x[:, None] + sq_y[None, :])
            bound = 1e-5 * want + slack.sqrt()
        elif name == "pairwise_cosine_similarity":
            bound = torch.full_like(want, 1e-5)
        else:
            bound = 1e-5 * want.abs()
        if not bool(torch.all(err <= bound)):
            raise AssertionError(f"{name}: float32 vs float64 max err {err.max().item()}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = event_ms(torch, lambda: fn(x, y), reps=3, warmup=1)
        out[name] = {"ms": ms, "max_abs_err": err.max().item(), "peak_bytes": torch.cuda.max_memory_allocated() - base}
    emit({"phase": "image", "config": "pairwise_4096x4096x2048", "card": smi, "functions": out})


def div2k_batch(torch, seed: int, i: int):
    """Update ``i`` of the DIV2K-shaped set: smooth fields (bicubic from 1/8 size) in
    [0, 1] as targets, preds = target + N(0, 0.05) clipped."""
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 30 + i)
    n, h, w = DIV2K["batch"], DIV2K["height"], DIV2K["width"]
    low = torch.rand((n, 3, h // 8, w // 8), generator=g, device="cuda")
    target = torch.nn.functional.interpolate(low, size=(h, w), mode="bicubic", align_corners=False).clamp_(0, 1)
    noise = torch.randn(target.shape, generator=g, device="cuda") * DIV2K["noise"]
    return (target + noise).clamp_(0, 1), target


def luma(img):
    """ITU-R BT.601 luma of an RGB batch, (N, 1, H, W)."""
    return (0.299 * img[:, 0:1] + 0.587 * img[:, 1:2] + 0.114 * img[:, 2:3])


def uqi_map64(torch, preds, target):
    """The UQI map in float64 by the port's window helpers (the functional casts to float32)."""
    from metrics_tpu_torch.functional.image.helper import _gaussian, _reflection_pad_2d, _separable_blur_2d

    g = _gaussian(11, 1.5, torch.float64, preds.device)[0]
    p, t = _reflection_pad_2d(preds, 5, 5), _reflection_pad_2d(target, 5, 5)
    mu_p, mu_t, pp, tt, pt = _separable_blur_2d(torch.cat((p, t, p * p, t * t, p * t)), g, g).chunk(5)
    var_p, var_t, cov = pp - mu_p**2, tt - mu_t**2, pt - mu_p * mu_t
    eps = torch.finfo(torch.float32).eps
    uqi = (2 * mu_p * mu_t) * (2 * cov) / ((mu_p**2 + mu_t**2) * (var_p + var_t) + eps)
    return uqi[..., 5:-5, 5:-5]


def image_div2k(torch, seed: int, smi: str) -> None:
    """SSIM, MS-SSIM, PSNR, PSNRB (luma), UQI and TV over the DIV2K-shaped set."""
    import math

    import torch.nn.functional as F

    from metrics_tpu_torch.functional import image as tfi
    from metrics_tpu_torch.functional.image.helper import _gaussian, _reflection_pad_2d, _separable_blur_2d
    from metrics_tpu_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update
    from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_update
    from metrics_tpu_torch.functional.image.tv import _total_variation_update
    from metrics_tpu_torch.image import (
        MultiScaleStructuralSimilarityIndexMeasure,
        PeakSignalNoiseRatio,
        PeakSignalNoiseRatioWithBlockedEffect,
        StructuralSimilarityIndexMeasure,
        TotalVariation,
        UniversalImageQualityIndex,
    )
    from metrics_tpu_torch.utils.compute import fp32_exact

    makers = {
        "ssim": lambda: StructuralSimilarityIndexMeasure(data_range=1.0),
        "ms_ssim": lambda: MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0),
        "psnr": lambda: PeakSignalNoiseRatio(data_range=1.0),
        "psnrb_luma": lambda: PeakSignalNoiseRatioWithBlockedEffect(),
        "uqi": lambda: UniversalImageQualityIndex(),
        "tv": lambda: TotalVariation(),
    }
    inputs = {"psnrb_luma": lambda p, t: (luma(p), luma(t)), "tv": lambda p, t: (p,)}
    metrics = {name: make() for name, make in makers.items()}
    pairs = {name: [] for name in metrics}
    ref = {"ssim": 0.0, "ms_ssim": 0.0, "sse": 0.0, "n": 0, "psnrb": [0.0, 0.0, 0, 0.0], "uqi": [0.0, 0], "tv": 0.0}
    updates = DIV2K["images"] // DIV2K["batch"]
    t0 = time.perf_counter()
    for i in range(updates):
        preds, target = div2k_batch(torch, seed, i)
        for name, metric in metrics.items():
            args = inputs.get(name, lambda p, t: (p, t))(preds, target)
            timed_call(torch, pairs[name], lambda: metric.update(*args))
        p64, t64 = preds.double(), target.double()
        ref["ssim"] += _ssim_update(p64, t64, data_range=1.0).sum().item()
        ref["ms_ssim"] += _multiscale_ssim_update(p64, t64, data_range=1.0, normalize="relu").sum().item()
        ref["sse"] += ((p64 - t64) ** 2).sum().item()
        ref["n"] += p64.numel()
        sse, bef, n = _psnrb_update(luma(p64), luma(t64))
        lt = luma(t64)
        ref["psnrb"] = [ref["psnrb"][0] + sse.item(), ref["psnrb"][1] + bef.item(), ref["psnrb"][2] + n.item(),
                        max(ref["psnrb"][3], (lt.max() - lt.min()).item())]
        uqi = uqi_map64(torch, p64, t64)
        ref["uqi"] = [ref["uqi"][0] + uqi.sum().item(), ref["uqi"][1] + uqi.numel()]
        ref["tv"] += _total_variation_update(p64)[0].sum().item()
        del p64, t64, uqi
    update_ms = {name: statistics.median(events_ms(torch, p)) for name, p in pairs.items()}
    loop_seconds = time.perf_counter() - t0

    images = DIV2K["images"]
    psnrb_ref = _psnrb_compute(*(torch.tensor(v, dtype=torch.float64) for v in ref["psnrb"])).item()
    want = {"ssim": ref["ssim"] / images, "ms_ssim": ref["ms_ssim"] / images,
            "psnr": 10 * math.log10(1.0 / (ref["sse"] / ref["n"])), "psnrb_luma": psnrb_ref,
            "uqi": ref["uqi"][0] / ref["uqi"][1], "tv": ref["tv"]}
    got, compute_ms, errors = {}, {}, {}
    for name, metric in metrics.items():
        pairs = []
        got[name] = timed_call(torch, pairs, metric.compute).item()
        compute_ms[name] = events_ms(torch, pairs)[0]
        absolute = name in ("ssim", "ms_ssim", "uqi")
        errors[name] = abs(got[name] - want[name]) / (1.0 if absolute else abs(want[name]))
        if errors[name] > 1e-5:
            raise AssertionError(f"DIV2K {name}: {got[name]} vs float64 {want[name]}")

    # one image on the card against the port's CPU run
    preds, target = div2k_batch(torch, seed, 0)
    preds, target = preds[:1], target[:1]
    functionals = {
        "ssim": lambda p, t: tfi.structural_similarity_index_measure(p, t, data_range=1.0),
        "ms_ssim": lambda p, t: tfi.multiscale_structural_similarity_index_measure(p, t, data_range=1.0),
        "psnr": lambda p, t: tfi.peak_signal_noise_ratio(p, t, data_range=1.0),
        "psnrb_luma": lambda p, t: tfi.peak_signal_noise_ratio_with_blocked_effect(luma(p), luma(t)),
        "uqi": lambda p, t: tfi.universal_image_quality_index(p, t),
        "tv": lambda p, t: tfi.total_variation(p),
    }
    cpu_errors = {}
    for name, fn in functionals.items():
        card, cpu = fn(preds, target).item(), fn(preds.cpu(), target.cpu()).item()
        absolute = name in ("ssim", "ms_ssim", "uqi")
        cpu_errors[name] = abs(card - cpu) / (1.0 if absolute else abs(cpu))
        if cpu_errors[name] > 1e-5:
            raise AssertionError(f"DIV2K {name}: card {card} vs CPU {cpu}")

    # peak memory of one SSIM update, and the blur of its stack three ways
    preds, target = div2k_batch(torch, seed, 1)
    fresh = StructuralSimilarityIndexMeasure(data_range=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fresh.update(preds, target)
    torch.cuda.synchronize()
    ssim_peak = torch.cuda.max_memory_allocated() - base
    ssim_update_profile = profile_groups(torch, lambda: fresh.update(preds, target))
    p, t = _reflection_pad_2d(preds, 5, 5), _reflection_pad_2d(target, 5, 5)
    stack = torch.cat((p, t, p * p, t * t, p * t))
    del p, t
    g = _gaussian(11, 1.5, device="cuda")[0]
    window = (g[:, None] * g[None, :]).expand(3, 1, 11, 11)

    def band(size):
        d = torch.arange(size, device="cuda")[:, None] - torch.arange(size - 10, device="cuda")[None, :]
        return torch.where((d >= 0) & (d < 11), g[d.clamp(0, 10)], 0.0)

    bw, bh = band(stack.shape[-1]), band(stack.shape[-2])

    def product_window():
        with fp32_exact():
            return F.conv2d(stack, window, groups=3)

    def band_matmuls():
        with fp32_exact():
            return torch.matmul(bh.T, torch.matmul(stack, bw))

    def channels_as_batch():  # the same two passes as one-channel convs over N*C images
        n, c, h, w = stack.shape
        with fp32_exact():
            y = F.conv2d(stack.reshape(n * c, 1, h, w), g.reshape(1, 1, 1, -1))
            return F.conv2d(y, g.reshape(1, 1, -1, 1)).reshape(n, c, h - 10, w - 10)

    separable = _separable_blur_2d(stack, g, g)
    blur = {"separable_grouped_conv_port": {"ms": event_ms(torch, lambda: _separable_blur_2d(stack, g, g), reps=5)}}
    for name, fn in (("product_window_grouped_conv", product_window), ("band_matmuls", band_matmuls),
                     ("separable_channels_as_batch_conv", channels_as_batch)):
        blur[name] = {"ms": event_ms(torch, fn, reps=5), "max_abs_diff": (fn() - separable).abs().max().item()}
    emit({"phase": "image", "config": "div2k_x4_val", "card": smi, "images": images, "shape": [3, DIV2K["height"],
          DIV2K["width"]], "batch": DIV2K["batch"], "loop_seconds_incl_float64_refs": loop_seconds,
          "update_ms": update_ms, "compute_ms": compute_ms, "values": got, "float64": want,
          "err_vs_float64": errors, "err_card_vs_cpu_one_image": cpu_errors, "ssim_update_peak_bytes": ssim_peak,
          "ssim_update_profile": ssim_update_profile,
          "blur_stack_shape": list(stack.shape), "blur": blur})


def phase_image(torch, seed: int, smi: str):
    """Image and pairwise at published shapes; no hand kernel on this path (both launch counts 0)."""
    t0 = time.perf_counter()
    (x, y), launches, _ = run_counted(torch, lambda: image_inception_metrics(torch, seed, smi))
    torch.cuda.empty_cache()
    image_pairwise(torch, x, y, smi)
    del x, y
    torch.cuda.empty_cache()
    _, div2k_launches, _ = run_counted(torch, lambda: image_div2k(torch, seed, smi))
    torch.cuda.empty_cache()
    expect_launches("image", launches, 0, 0)
    expect_launches("image div2k", div2k_launches, 0, 0)
    emit({"phase": "image", "config": "all", "launches": launches, "seconds": time.perf_counter() - t0})


COCO_DET = {"images": 5_000, "width": 640, "height": 480, "gt_boxes": 36_781, "detections": 100, "batch": 100,
            "area_shares": (0.41, 0.34, 0.25), "person_share": 0.3, "crowded_images": 20, "crowded_gts": (40, 61),
            "crowded_person_share": 0.7, "tp_share": 0.85, "exact_share": 0.04}
DET_SUBSETS = {"cpu_consolidated": 1_000, "cpu_list": 200, "reference": 500, "iou_cpu": 200, "segm": 100,
               "segm_top": 20, "panoptic": 100, "panoptic_batch": 10}
COCO_THING_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 27, 28, 31,
                  32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
                  58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
                  88, 89, 90)
COCO_STUFF_IDS = (92, 93, 95, 100, 107, 109, 112, 118, 119, 122, 125, 128, 130, 133, 138, 141, 144, 145, 147, 148,
                  149, 151, 154, 155, 156, 159, 161, 166, 168, 171, 175, 176, 177, 178, 180, 181, 184, 185, 186, 187,
                  188, 189, 190, 191, 192, 193, 194, 195, 196, 197, 198, 199, 200)
MAP_ATOL = 1e-6  # layouts, devices, the float64 evaluator and segm against bbox
IOU_ATOL = 1e-5  # the four IoU classes (float32 per-image means) against float64


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def quarter(torch, x):
    """Coordinates on quarter pixels: every box area, intersection and union below 2^20 is
    then exact in float32, so float32 and float64 IoUs round to the same float32."""
    return torch.round(x * 4) / 4


def random_boxes(torch, g, n: int, device):
    """``n`` boxes inside the image, areas split as COCO's small / medium / large."""
    W, H = COCO_DET["width"], COCO_DET["height"]
    size = torch.multinomial(torch.tensor(COCO_DET["area_shares"], device=device), n, replacement=True, generator=g)
    lo = torch.tensor([8.0, 32.0, 96.0], device=device)[size].log() * 2
    hi = torch.tensor([32.0, 96.0, 320.0], device=device)[size].log() * 2
    area = torch.exp(lo + torch.rand(n, generator=g, device=device) * (hi - lo))
    ratio = torch.exp((torch.rand(n, generator=g, device=device) - 0.5) * 1.4)
    w = torch.sqrt(area * ratio).clamp(1, W)
    h = torch.sqrt(area / ratio).clamp(1, H)
    x0 = torch.rand(n, generator=g, device=device) * (W - w)
    y0 = torch.rand(n, generator=g, device=device) * (H - h)
    return quarter(torch, torch.stack([x0, y0, x0 + w, y0 + h], -1))


def coco_detection_data(torch, seed: int, device="cuda") -> dict:
    """COCO 2017 val object detection drawn from ``seed``: 5,000 images of 640x480, the
    36,781 ground-truth boxes of ``instances_val2017`` over COCO's 80 category ids, 100
    detections an image (jittered copies of 85% of the gts, false positives of random
    class and place), scores rounded through bfloat16. The 20 crowded images (40-60
    gts, mostly persons: the only (image, class) groups above 16) sit at random
    places among the others. Every image has a gt.
    """
    c = COCO_DET
    g = torch.Generator(device=device).manual_seed(seed + 80)
    B, W, H, D = c["images"], c["width"], c["height"], c["detections"]
    ids = torch.tensor(COCO_THING_IDS, device=device)
    crowded = c["crowded_images"]
    n_crowd = torch.randint(*c["crowded_gts"], (crowded,), generator=g, device=device)
    is_crowded = torch.zeros(B, dtype=torch.bool, device=device)
    is_crowded[torch.randperm(B, generator=g, device=device)[:crowded]] = True
    spread = c["gt_boxes"] - int(n_crowd.sum()) - (B - crowded)
    others = torch.nonzero(~is_crowded).flatten()
    img = others[torch.randint(0, B - crowded, (spread,), generator=g, device=device)]
    counts = 1 + torch.bincount(img, minlength=B)
    counts[is_crowded] = n_crowd
    gt_img = torch.repeat_interleave(torch.arange(B, device=device), counts)
    n = gt_img.numel()
    person_p = torch.where(is_crowded[gt_img], c["crowded_person_share"], c["person_share"])
    is_person = torch.rand(n, generator=g, device=device) < person_p
    gt_labels = torch.where(is_person, ids[0], ids[1:][torch.randint(0, 79, (n,), generator=g, device=device)])
    gt_boxes = random_boxes(torch, g, n, device)

    # true positives: jittered copies, IoU from ~0.3 to ~0.98
    tp = torch.rand(n, generator=g, device=device) < c["tp_share"]
    sigma = 0.01 + 0.24 * torch.rand(n, generator=g, device=device)
    wh = (gt_boxes[:, 2:] - gt_boxes[:, :2]).repeat(1, 2)
    det = quarter(torch, gt_boxes + torch.randn((n, 4), generator=g, device=device) * sigma[:, None] * wh)
    det = torch.stack([det[:, 0].clamp(0, W - 1), det[:, 1].clamp(0, H - 1), det[:, 2], det[:, 3]], -1)
    det[:, 2] = torch.maximum(det[:, 2], det[:, 0] + 0.25).clamp(max=W)
    det[:, 3] = torch.maximum(det[:, 3], det[:, 1] + 0.25).clamp(max=H)
    # integer pairs whose IoU is exactly 0.5 or 0.75: the detection is the gt's left half or three quarters
    exact = tp & (torch.rand(n, generator=g, device=device) < c["exact_share"] / c["tp_share"])
    gi = torch.round(gt_boxes)
    w4 = (torch.round((gi[:, 2] - gi[:, 0]) / 4).clamp(min=1) * 4).clamp(max=W - W % 4)
    x0 = torch.minimum(gi[:, 0], W - w4)
    y1 = torch.maximum(gi[:, 3], gi[:, 1] + 1)
    k = torch.where(torch.rand(n, generator=g, device=device) < 0.5, 0.5, 0.75)
    gt_boxes = torch.where(exact[:, None], torch.stack([x0, gi[:, 1], x0 + w4, y1], -1), gt_boxes)
    det = torch.where(exact[:, None], torch.stack([x0, gi[:, 1], x0 + w4 * k, y1], -1), det)
    bf16 = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731

    n_tp = torch.bincount(gt_img[tp], minlength=B)
    n_fp = D - n_tp
    fp_img = torch.repeat_interleave(torch.arange(B, device=device), n_fp)
    nf = fp_img.numel()
    all_img = torch.cat([gt_img[tp], fp_img])
    boxes = torch.cat([det[tp], random_boxes(torch, g, nf, device)])
    labels = torch.cat([gt_labels[tp], ids[torch.randint(0, 80, (nf,), generator=g, device=device)]])
    scores = bf16(torch.cat([torch.sigmoid(torch.randn(int(tp.sum()), generator=g, device=device) + 1.0),
                             torch.sigmoid(torch.randn(nf, generator=g, device=device) - 1.0)]))
    # by image, in random order inside each image
    order = torch.argsort(all_img.double() + 0.5 * torch.rand(all_img.numel(), generator=g, device=device,
                                                              dtype=torch.float64))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=device) - offsets[gt_img]
    mg = int(counts.max())
    gt_pad = torch.zeros((B, mg, 4), device=device)
    gl_pad = torch.full((B, mg), -1, dtype=torch.int64, device=device)
    gt_pad[gt_img, pos] = gt_boxes
    gl_pad[gt_img, pos] = gt_labels
    return {"det_boxes": boxes[order].reshape(B, D, 4), "det_scores": scores[order].reshape(B, D),
            "det_labels": labels[order].reshape(B, D), "gt_boxes": gt_pad, "gt_labels": gl_pad,
            "counts": counts.tolist(), "crowded": torch.nonzero(is_crowded).flatten().tolist(),
            "exact_pairs": int(exact.sum()), "tp": int(tp.sum())}


def det_consolidated(data, lo: int, hi: int):
    return ({"boxes": data["det_boxes"][lo:hi], "scores": data["det_scores"][lo:hi],
             "labels": data["det_labels"][lo:hi]},
            {"boxes": data["gt_boxes"][lo:hi], "labels": data["gt_labels"][lo:hi]})


def det_list(data, lo: int, hi: int):
    counts = data["counts"]
    preds = [{"boxes": data["det_boxes"][i], "scores": data["det_scores"][i], "labels": data["det_labels"][i]}
             for i in range(lo, hi)]
    target = [{"boxes": data["gt_boxes"][i, :counts[i]], "labels": data["gt_labels"][i, :counts[i]]}
              for i in range(lo, hi)]
    return preds, target


def det_on(data, device) -> dict:
    return {k: v.to(device) if hasattr(v, "to") else v for k, v in data.items()}


def run_updates(torch, updates, device="cuda", **kwargs):
    """MeanAveragePrecision(class_metrics=True) over ``updates``; returns the metric, its
    result, the host ms of each update and of the compute, and the compute's greedy-match
    launches."""
    from metrics_tpu_torch.detection import MeanAveragePrecision
    from metrics_tpu_torch.ops import greedy_match as gm

    metric = MeanAveragePrecision(class_metrics=True, device=device, **kwargs)
    update_ms = []
    for args in updates:
        sync(torch, device)
        t0 = time.perf_counter()
        metric.update(*args)
        sync(torch, device)
        update_ms.append((time.perf_counter() - t0) * 1e3)
    before = gm.greedy_match_cuda.launches
    t0 = time.perf_counter()
    result = metric.compute()
    sync(torch, device)
    compute_ms = (time.perf_counter() - t0) * 1e3
    return metric, result, update_ms, compute_ms, gm.greedy_match_cuda.launches - before


def run_map(torch, data, lo: int, hi: int, layout: str, device="cuda", **kwargs):
    """``run_updates`` over images [lo, hi) in updates of 100 images of one layout."""
    make = det_consolidated if layout == "consolidated" else det_list
    step = COCO_DET["batch"]
    return run_updates(torch, [make(data, s, min(s + step, hi)) for s in range(lo, hi, step)], device, **kwargs)


def map_max_diff(a: dict, b: dict) -> float:
    """Largest difference over every result key of two mAP results; raises if the keys
    or the classes differ."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"result keys differ: {sorted(a)} vs {sorted(b)}")
    worst = 0.0
    for key in a:
        x = a[key].detach().double().cpu().reshape(-1)
        y = b[key].detach().double().cpu().reshape(-1) if hasattr(b[key], "detach") else b[key]
        if key == "classes":
            if x.tolist() != list(y.tolist() if hasattr(y, "tolist") else y):
                raise AssertionError("classes differ")
            continue
        if len(x) != len(y):
            raise AssertionError(f"{key}: {len(x)} values against {len(y)}")
        worst = max(worst, max((abs(float(u) - float(v)) for u, v in zip(x, y)), default=0.0))
    return worst


def expect_close(label: str, diff: float, atol: float) -> None:
    if not diff <= atol:
        raise AssertionError(f"{label}: max abs diff {diff} above {atol}")


def iou64(np, a, b):
    """Pairwise box IoU in float64."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0), inter, union


def map_reference(np, det_boxes, det_scores, det_labels, gt_boxes, gt_labels, counts, metric) -> dict:
    """COCO mAP in float64 numpy, independent of both packages, with the semantics the JAX
    package keeps: per (image, class) the top ``max_det`` detections by score (stable),
    greedy matching in score order to the free in-range ground truth of largest IoU (the
    first of equal IoUs), a match only when that IoU is strictly above the float32
    threshold, no crowd, ignored gts never matched, unmatched out-of-range detections
    ignored; per class the rows of every image in image order, stably sorted by score,
    float64 cumulative TP/FP, the reverse-max precision envelope and the 101 recall points
    by ``searchsorted(side="left")``; each summary the mean of the entries above -1.
    IoUs are float64 from quarter-pixel boxes (exact operands), rounded to float32."""
    thr = np.asarray(metric.iou_thresholds, np.float32)
    rec_thr = np.asarray(metric.rec_thresholds, np.float64)
    caps = list(metric.max_detection_thresholds)
    ranges = np.asarray(list(metric.bbox_area_ranges.values()), np.float32).astype(np.float64)
    lo, hi = ranges[:, 0][:, None], ranges[:, 1][:, None]
    T, R, A, M = len(thr), len(rec_thr), len(ranges), len(caps)
    gl_all = [gt_labels[i, :counts[i]] for i in range(len(counts))]
    classes = sorted(set(np.unique(det_labels).tolist()) | set(np.unique(np.concatenate(gl_all)).tolist()))
    rows = {k: [] for k in classes}
    npig = {k: np.zeros(A, np.int64) for k in classes}
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    for i in range(len(counts)):
        dl, gl = det_labels[i], gl_all[i]
        for k in np.unique(np.concatenate([dl, gl])).tolist():
            sel = np.nonzero(dl == k)[0]
            order = sel[np.argsort(-det_scores[i, sel], kind="stable")][:caps[-1]]
            db = det_boxes[i, order].astype(np.float64)
            gb = gt_boxes[i, :counts[i]][gl == k].astype(np.float64)
            iou = iou64(np, db, gb)[0].astype(np.float32)
            g_out = (area(gb)[None, :] < lo) | (area(gb)[None, :] > hi)  # (A, G)
            npig[k] += (~g_out).sum(1)
            removed = np.repeat(g_out[:, None, :], T, axis=1)  # (A, T, G)
            matched = np.zeros((A, T, len(order)), bool)
            for d in range(len(order)):
                if not gb.shape[0]:
                    break
                cand = np.where(removed, np.float32(-1), iou[d][None, None, :])
                m = cand.argmax(-1)
                hit = np.take_along_axis(cand, m[..., None], -1)[..., 0] > thr[None, :]
                a_idx, t_idx = np.nonzero(hit)
                removed[a_idx, t_idx, m[a_idx, t_idx]] = True
                matched[..., d] = hit
            d_out = (area(db)[None, :] < lo) | (area(db)[None, :] > hi)  # (A, D)
            rows[k].append((det_scores[i, order].astype(np.float64), matched, ~matched & d_out[:, None, :],
                            np.arange(len(order))))
    precision = -np.ones((T, R, len(classes), A, M))
    recall = -np.ones((T, len(classes), A, M))
    for kidx, k in enumerate(classes):
        sc = np.concatenate([r[0] for r in rows[k]])
        mt = np.concatenate([r[1] for r in rows[k]], axis=-1)
        ig = np.concatenate([r[2] for r in rows[k]], axis=-1)
        rank = np.concatenate([r[3] for r in rows[k]])
        for a in range(A):
            if npig[k][a] == 0:
                continue
            for mi, cap in enumerate(caps):
                keep = rank < cap
                order = np.argsort(-sc[keep], kind="stable")
                m = mt[a][:, keep][:, order]
                ign = ig[a][:, keep][:, order]
                tps = np.cumsum(m & ~ign, axis=1, dtype=np.float64)
                fps = np.cumsum(~m & ~ign, axis=1, dtype=np.float64)
                nd = tps.shape[1]
                rc = tps / npig[k][a]
                pr = tps / (tps + fps + np.finfo(np.float64).eps)
                recall[:, kidx, a, mi] = rc[:, -1] if nd else 0.0
                env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                for t in range(T):
                    inds = np.searchsorted(rc[t], rec_thr, side="left")
                    precision[t, :, kidx, a, mi] = np.where(inds < nd, env[t][np.minimum(inds, nd - 1)], 0.0) \
                        if nd else 0.0

    def mean(x):
        v = x[x > -1]
        return -1.0 if v.size == 0 else float(v.mean())

    t50, t75 = metric.iou_thresholds.index(0.5), metric.iou_thresholds.index(0.75)
    out = {"map": mean(precision[..., 0, -1]), "map_50": mean(precision[t50, ..., 0, -1]),
           "map_75": mean(precision[t75, ..., 0, -1]), "map_small": mean(precision[..., 1, -1]),
           "map_medium": mean(precision[..., 2, -1]), "map_large": mean(precision[..., 3, -1]),
           "mar_small": mean(recall[..., 1, -1]), "mar_medium": mean(recall[..., 2, -1]),
           "mar_large": mean(recall[..., 3, -1]),
           "map_per_class": [mean(precision[:, :, kidx, 0, -1]) for kidx in range(len(classes))],
           f"mar_{caps[-1]}_per_class": [mean(recall[:, kidx, 0, -1]) for kidx in range(len(classes))],
           "classes": classes}
    for mi, cap in enumerate(caps):
        out[f"mar_{cap}"] = mean(recall[:, :, 0, mi])
    return out


def iou_class_reference(np, det_boxes, det_labels, gt_boxes, gt_labels, counts) -> dict:
    """The four IoU classes' values in float64 numpy: per image the mean of the (100, G)
    matrix, label-mismatched pairs at the class's invalid value (label lists of unequal
    length never count as equal), then the mean over the images."""
    per = {"iou": [], "giou": [], "diou": [], "ciou": []}
    eps = 1e-7
    for i in range(len(counts)):
        p, t = det_boxes[i].astype(np.float64), gt_boxes[i, :counts[i]].astype(np.float64)
        mismatch = det_labels[i][:, None] != gt_labels[i, :counts[i]][None, :]
        iou, inter, union = iou64(np, p, t)
        lt = np.minimum(p[:, None, :2], t[None, :, :2])
        rb = np.maximum(p[:, None, 2:], t[None, :, 2:])
        ewh = np.clip(rb - lt, 0, None)
        enclosing = ewh[..., 0] * ewh[..., 1]
        giou = inter / union - (enclosing - union) / enclosing
        cp, ct = (p[:, :2] + p[:, 2:]) / 2, (t[:, :2] + t[:, 2:]) / 2
        center = ((cp[:, None, :] - ct[None, :, :]) ** 2).sum(-1)
        diou = iou - center / ((ewh ** 2).sum(-1) + eps)
        wp, hp, wt, ht = p[:, 2] - p[:, 0], p[:, 3] - p[:, 1], t[:, 2] - t[:, 0], t[:, 3] - t[:, 1]
        v = (4 / np.pi ** 2) * (np.arctan(wt / ht)[None, :] - np.arctan(wp / hp)[:, None]) ** 2
        ciou = diou - v / (1 - iou + v + eps) * v
        for key, value, invalid in (("iou", iou, 0.0), ("giou", giou, -1.0), ("diou", diou, -1.0),
                                    ("ciou", ciou, -2.0)):
            per[key].append(np.where(mismatch, invalid, value).mean())
    return {k: float(np.mean(v)) for k, v in per.items()}


def run_iou_classes(torch, data, lo: int, hi: int, device="cuda") -> tuple:
    """The four IoU classes over images [lo, hi) in updates of 100 images: values, update
    ms (per update) and compute ms of each."""
    from metrics_tpu_torch import detection as td

    values, timings = {}, {}
    for name in ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
                 "CompleteIntersectionOverUnion"):
        metric = getattr(td, name)(device=device)
        update_ms = []
        for s in range(lo, hi, COCO_DET["batch"]):
            args = det_list(data, s, min(s + COCO_DET["batch"], hi))
            sync(torch, device)
            t0 = time.perf_counter()
            metric.update(*args)
            sync(torch, device)
            update_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        result = metric.compute()
        sync(torch, device)
        timings[name] = {"update_ms": statistics.median(update_ms), "compute_ms": (time.perf_counter() - t0) * 1e3}
        values.update({k: float(v) for k, v in result.items()})
    return values, timings


def segm_inputs(torch, data, n: int, top: int):
    """The first ``n`` images' top ``top`` detections and their gts on whole pixels, as
    boxes and as filled ``H x W`` masks (the same pixels: mask IoU equals box IoU)."""
    H, W = COCO_DET["height"], COCO_DET["width"]
    dev = data["det_boxes"].device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]

    def whole(b):
        x0, y0 = torch.floor(b[:, 0]), torch.floor(b[:, 1])
        x1 = torch.maximum(torch.ceil(b[:, 2]), x0 + 1).clamp(max=W)
        y1 = torch.maximum(torch.ceil(b[:, 3]), y0 + 1).clamp(max=H)
        return torch.stack([x0, y0, x1, y1], -1)

    def masks(b):
        return ((xs >= b[:, 0, None, None]) & (xs < b[:, 2, None, None])
                & (ys >= b[:, 1, None, None]) & (ys < b[:, 3, None, None]))

    boxes_p, boxes_t, masks_p, masks_t = [], [], [], []
    for i in range(n):
        order = torch.sort(-data["det_scores"][i], stable=True).indices[:top]
        db = whole(data["det_boxes"][i, order])
        gb = whole(data["gt_boxes"][i, :data["counts"][i]])
        scores, labels, gl = data["det_scores"][i, order], data["det_labels"][i, order], \
            data["gt_labels"][i, :data["counts"][i]]
        boxes_p.append({"boxes": db, "scores": scores, "labels": labels})
        boxes_t.append({"boxes": gb, "labels": gl})
        masks_p.append({"masks": masks(db), "scores": scores, "labels": labels})
        masks_t.append({"masks": masks(gb), "labels": gl})
    return boxes_p, boxes_t, masks_p, masks_t


def panoptic_maps(torch, data, seed: int, n: int):
    """``n`` panoptic (category, instance) maps of 480x640 on the COCO panoptic val2017
    categories (80 things, 53 stuffs), drawn from ``seed`` and the detection data: stuff
    on a 6 x 8 grid of 80-pixel cells (four stuff categories an image; 15% of the cells
    changed in the preds), the image's gt boxes painted as thing instances in the target
    and its detections scored 0.6 or more (in ascending score) in the preds, and three
    40 x 40 void patches (category 0) in the target."""
    H, W = COCO_DET["height"], COCO_DET["width"]
    dev = data["det_boxes"].device
    g = torch.Generator(device=dev).manual_seed(seed + 133)
    stuff = torch.tensor(COCO_STUFF_IDS, device=dev)
    pick = stuff[torch.randint(0, len(COCO_STUFF_IDS), (n, 4), generator=g, device=dev)]
    cells = torch.randint(0, 4, (n, 48), generator=g, device=dev)
    other = torch.randint(0, 4, (n, 48), generator=g, device=dev)
    changed = torch.rand((n, 48), generator=g, device=dev) < 0.15
    t_cat = torch.gather(pick, 1, cells).reshape(n, 6, 8)
    p_cat = torch.gather(pick, 1, torch.where(changed, other, cells)).reshape(n, 6, 8)
    up = lambda x: x.repeat_interleave(80, 1).repeat_interleave(80, 2)  # noqa: E731
    zeros = torch.zeros((n, H, W), dtype=torch.int64, device=dev)
    target = torch.stack([up(t_cat), zeros], -1)
    preds = torch.stack([up(p_cat), zeros.clone()], -1)
    gb, gl = data["gt_boxes"][:n].cpu(), data["gt_labels"][:n].cpu()
    db, dl, ds = data["det_boxes"][:n].cpu(), data["det_labels"][:n].cpu(), data["det_scores"][:n].cpu()
    void = torch.randint(0, 440, (n, 3, 2), generator=g, device=dev).cpu()
    for i in range(n):
        for j in range(data["counts"][i]):
            x0, y0, x1, y1 = (int(v) for v in torch.round(gb[i, j]).tolist())
            target[i, y0:y1, x0:x1, 0] = int(gl[i, j])
            target[i, y0:y1, x0:x1, 1] = j + 1
        keep = torch.nonzero(ds[i] >= 0.6).reshape(-1)
        for rank, j in enumerate(keep[torch.sort(ds[i][keep], stable=True).indices].tolist()):
            x0, y0, x1, y1 = (int(v) for v in torch.round(db[i, j]).tolist())
            preds[i, y0:y1, x0:x1, 0] = int(dl[i, j])
            preds[i, y0:y1, x0:x1, 1] = rank + 1
        for y, x in void[i].tolist():
            target[i, y:y + 40, x:x + 40] = 0
    return preds, target


def run_panoptic(torch, preds, target, device, batch: int):
    from metrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality

    out = {}
    for cls in (PanopticQuality, ModifiedPanopticQuality):
        metric = cls(things=set(COCO_THING_IDS), stuffs=set(COCO_STUFF_IDS), device=device)
        update_ms = []
        for s in range(0, preds.shape[0], batch):
            sync(torch, device)
            t0 = time.perf_counter()
            metric.update(preds[s:s + batch], target[s:s + batch])
            sync(torch, device)
            update_ms.append((time.perf_counter() - t0) * 1e3)
        out[cls.__name__] = {"pq": float(metric.compute()), "update_ms": statistics.median(update_ms),
                             "counts": [getattr(metric, s).cpu() for s in ("true_positives", "false_positives",
                                                                           "false_negatives")]}
    return out


class RecordingMatch:
    """Stands in for the greedy-match wrapper: launches the kernel, keeps each call's inputs
    while ``keep`` is set."""

    def __init__(self, kernel):
        self.kernel, self.calls, self.keep = kernel, [], True

    @property
    def launches(self) -> int:
        return self.kernel.launches

    def __call__(self, *args):
        if self.keep:
            self.calls.append(args)
        return self.kernel(*args)


def match_case(torch, g, n: int, d: int, g_count: int, device="cuda"):
    """A synthetic greedy-match input: tied IoUs, IoUs exactly at 0.5 and 0.75 (and one
    float above 0.5), areas in every COCO range (area-ignored gts), invalid rows, and
    groups without a valid detection or gt."""
    special = torch.tensor([0.0, 0.5, 0.75, 0.50000006, 0.9, 0.3], device=device)
    iou = special[torch.randint(0, 6, (n, d, g_count), generator=g, device=device)]
    free = torch.rand((n, d, g_count), generator=g, device=device) < 0.4
    iou = torch.where(free, torch.rand((n, d, g_count), generator=g, device=device), iou)
    areas = torch.tensor([10.0, 32.0 ** 2, 1500.0, 96.0 ** 2, 2e4], device=device)
    d_area = areas[torch.randint(0, 5, (n, d), generator=g, device=device)]
    g_area = areas[torch.randint(0, 5, (n, g_count), generator=g, device=device)]
    dv = torch.rand((n, d), generator=g, device=device) >= 0.2
    gv = torch.rand((n, g_count), generator=g, device=device) >= 0.2
    if n > 2:
        dv[1] = False
        gv[2] = False
    return iou, d_area, g_area, dv, gv


def match_bytes(iou, det_valid, gt_valid, thresholds, ranges) -> int:
    """Bytes the greedy match must move: the IoU entries of valid (detection, gt) pairs,
    the areas, masks, thresholds and ranges read once, each output written once."""
    n, d, g = iou.shape
    t, a = thresholds.numel(), ranges.shape[0]
    pairs = int((det_valid.long().sum(1) * gt_valid.long().sum(1)).sum())
    return 4 * pairs + 5 * n * d + 5 * n * g + 4 * t + 8 * a + 2 * n * a * t * d + 4 * n * a


def match_timing(torch, args, label: str) -> dict:
    from metrics_tpu_torch.ops.greedy_match import _plain_greedy_match, greedy_match_cuda

    call = lambda: greedy_match_cuda(*args)  # noqa: E731
    dev = None
    for _ in range(3):  # a profile late in a long process sometimes records no kernel: None if none does
        dev = sum(v for k, v in device_ms(torch, call).items() if "greedy_match" in k) or None
        if dev:
            break
    bound_ms = match_bytes(args[0], args[3], args[4], args[5], args[6]) / HBM_BYTES_PER_S * 1e3
    return {"shape": label, "kernel_ms": event_ms(torch, call, warmup=5), "device_ms": dev,
            "kernel_ms_back_to_back": back_to_back_ms(torch, call),
            "plain_ms": event_ms(torch, lambda: _plain_greedy_match(*args), reps=3, warmup=1),
            "bound_ms": bound_ms, "kernel_share_of_bound": bound_ms / dev if dev else None}


def check_match_kernel(torch, cases) -> tuple:
    """Each (label, args) case through the kernel and its plain version on the card, the
    three outputs bit-equal; returns the number of cases and the largest difference."""
    from metrics_tpu_torch.ops.greedy_match import _plain_greedy_match, greedy_match_cuda

    err = 0
    for label, args in cases:
        got = greedy_match_cuda(*args)
        want = _plain_greedy_match(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("det_matched", "det_ignored", "npig"), got, want):
            diff = int((a.int() - b.int()).abs().max()) if a.numel() else 0
            err = max(err, diff)
            if a.dtype != b.dtype or diff:
                raise AssertionError(f"greedy match kernel != plain at {label}: {name}")
    return len(cases), err


def phase_detection(torch, seed: int, smi: str):
    """COCO 2017 val detection through mAP (both layouts, segm), the IoU family and panoptic quality."""
    import numpy as np

    from metrics_tpu_torch.functional.detection._mean_ap_device import plan_buckets
    from metrics_tpu_torch.ops import greedy_match as gm
    from metrics_tpu_torch.ops.greedy_match import greedy_match_cuda
    from metrics_tpu_torch.ops.histogram import histogram_cuda

    t_phase = time.perf_counter()
    data = coco_detection_data(torch, seed)
    B, sub = COCO_DET["images"], DET_SUBSETS
    person = COCO_THING_IDS.index(1)
    # the bucket routing the data was drawn for: the big groups are the crowded images' persons
    dl_np, gl_np = data["det_labels"].cpu().numpy(), data["gt_labels"].cpu().numpy()
    ids_np = np.asarray(COCO_THING_IDS)
    det_counts = (dl_np[:, :, None] == ids_np).sum(1)
    gt_counts = (gl_np[:, :, None] == ids_np).sum(1)
    _, big_pairs, d_big, g_big = plan_buckets(det_counts, gt_counts, 100)
    if sorted(big_pairs) != [(b, person) for b in data["crowded"]]:
        raise AssertionError(f"big groups {big_pairs[:5]}... are not the crowded images' persons")
    gb = data["gt_boxes"]
    sizes = (gb[..., 2] - gb[..., 0]) * (gb[..., 3] - gb[..., 1])
    valid = data["gt_labels"] >= 0
    shares = [float(((sizes < hi) & (sizes >= lo) & valid).sum()) / sum(data["counts"])
              for lo, hi in ((0, 32 ** 2), (32 ** 2, 96 ** 2), (96 ** 2, 1e10))]
    emit({"phase": "detection", "config": "data", "images": B, "gt_boxes": sum(data["counts"]),
          "detections": B * COCO_DET["detections"], "true_positive_copies": data["tp"],
          "exact_threshold_pairs": data["exact_pairs"], "gt_area_shares": shares,
          "max_gts_per_image": max(data["counts"]), "crowded_images": data["crowded"],
          "big_groups": len(big_pairs), "d_big": d_big, "g_big": g_big})

    # ---- the main path, with the launch counts at 0 just before and read just after
    recorder = RecordingMatch(greedy_match_cuda)
    gm.greedy_match_cuda = recorder
    torch.cuda.synchronize()
    histogram_cuda.launches = greedy_match_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        runs = {"consolidated": run_map(torch, data, 0, B, "consolidated")}
        recorder.keep = False
        runs["list"] = run_map(torch, data, 0, B, "list")
        for layout, n in (("consolidated", sub["cpu_consolidated"]), ("list", sub["cpu_list"]),
                          ("list", sub["reference"])):
            runs[f"{layout}_first_{n}"] = run_map(torch, data, 0, n, layout)
        boxes_p, boxes_t, masks_p, masks_t = segm_inputs(torch, data, sub["segm"], sub["segm_top"])
        runs["segm"] = run_updates(torch, [(masks_p, masks_t)], iou_type="segm")
        runs["segm_boxes"] = run_updates(torch, [(boxes_p, boxes_t)])
        del masks_p, masks_t
        iou_values, iou_timings = run_iou_classes(torch, data, 0, B)
        iou_first, _ = run_iou_classes(torch, data, 0, sub["iou_cpu"])
        pq_preds, pq_target = panoptic_maps(torch, data, seed, sub["panoptic"])
        pq = run_panoptic(torch, pq_preds, pq_target, "cuda", sub["panoptic_batch"])
        torch.cuda.synchronize()
    finally:
        gm.greedy_match_cuda = greedy_match_cuda
    drive_s = time.perf_counter() - t0
    launches = {"greedy_match": greedy_match_cuda.launches, "histogram": histogram_cuda.launches}
    per_compute = {name: run[4] for name, run in runs.items()}
    for name, got in per_compute.items():
        if got != (2 if name.startswith("consolidated") else 1):
            raise AssertionError(f"{name}: {got} greedy-match launches in its compute")
    if launches != {"greedy_match": sum(per_compute.values()), "histogram": 2 * sub["panoptic"]}:
        raise AssertionError(f"detection launches {launches}, per compute {per_compute}")

    # ---- checks
    checks = {"consolidated_vs_list": map_max_diff(runs["consolidated"][1], runs["list"][1]),
              "segm_vs_bbox": map_max_diff(runs["segm"][1], runs["segm_boxes"][1])}
    data_cpu = det_on(data, "cpu")
    for name, layout, n in (("cpu_consolidated", "consolidated", sub["cpu_consolidated"]),
                            ("cpu_list", "list", sub["cpu_list"])):
        cpu = run_map(torch, data_cpu, 0, n, layout, device="cpu")
        if cpu[4] != 0:
            raise AssertionError(f"{name}: the CPU compute launched the kernel")
        checks[name] = map_max_diff(runs[f"{layout}_first_{n}"][1], cpu[1])
    n_ref = sub["reference"]
    ref = map_reference(np, *(data_cpu[k][:n_ref].numpy() for k in ("det_boxes", "det_scores", "det_labels",
                                                                    "gt_boxes", "gt_labels")),
                        data["counts"][:n_ref], runs[f"list_first_{n_ref}"][0])
    checks[f"float64_reference_{n_ref}"] = map_max_diff(
        runs[f"list_first_{n_ref}"][1], {k: torch.tensor(v, dtype=torch.float64) for k, v in ref.items()})
    for name, diff in checks.items():
        expect_close(name, diff, MAP_ATOL)
    result = runs["consolidated"][1]
    if not all(bool(torch.isfinite(v).all()) for v in result.values()):
        raise AssertionError("non-finite mAP result")

    iou_ref = iou_class_reference(np, *(data_cpu[k].numpy() for k in ("det_boxes", "det_labels", "gt_boxes",
                                                                      "gt_labels")), data["counts"])
    iou_cpu, _ = run_iou_classes(torch, data_cpu, 0, sub["iou_cpu"], device="cpu")
    iou_checks = {"float64": max(abs(iou_values[k] - iou_ref[k]) for k in iou_ref),
                  f"cpu_first_{sub['iou_cpu']}": max(abs(iou_first[k] - iou_cpu[k]) for k in iou_cpu)}
    expect_close("IoU classes against float64", iou_checks["float64"], IOU_ATOL)
    expect_close("IoU classes against the CPU", iou_checks[f"cpu_first_{sub['iou_cpu']}"], MAP_ATOL)

    pq_cpu = run_panoptic(torch, pq_preds.cpu(), pq_target.cpu(), "cpu", sub["panoptic_batch"])
    for name in pq:
        for got, want in zip(pq[name]["counts"], pq_cpu[name]["counts"]):
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: counts differ from the CPU run")
        expect_close(f"{name} against the CPU", abs(pq[name]["pq"] - pq_cpu[name]["pq"]), MAP_ATOL)
    del pq_preds, pq_target

    # ---- the kernel against its plain version, bit for bit (outside the counted run)
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    consolidated = runs["consolidated"][0]
    thresholds = torch.tensor(consolidated.iou_thresholds, dtype=torch.float32, device="cuda")
    ranges = consolidated._area_ranges()
    cases = [("COCO small bucket", recorder.calls[0]), ("COCO big bucket", recorder.calls[1])]
    for shape in ((7, 1, 9), (5, 9, 1), (3, 1, 1), (9, 20, 1024), (33, 13, 40), (4096, 16, 16)):
        cases.append(("x".join(map(str, shape)), (*match_case(torch, g, *shape), thresholds, ranges)))
    checked, match_err = check_match_kernel(torch, cases)

    # ---- timings
    small = match_timing(torch, recorder.calls[0], "x".join(map(str, recorder.calls[0][0].shape)))
    big = match_timing(torch, recorder.calls[1], "x".join(map(str, recorder.calls[1][0].shape)))
    recorder.calls.clear()

    def compute_again():
        consolidated._computed = None
        return consolidated.compute()

    compute_again()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_again()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compute_again()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    profile = group_kernels({k[:70]: v / 1e3 for k, v in device_events(prof).items()})
    listed = runs["list"][0]
    host = listed._fetch_host_states()
    classes = listed._get_classes(host)
    t0 = time.perf_counter()
    listed._build_groups(classes, host)
    build_groups_ms = (time.perf_counter() - t0) * 1e3

    emit({"phase": "detection", "config": "map", "nvidia_smi": smi,
          "map": float(result["map"]), "map_50": float(result["map_50"]), "map_75": float(result["map_75"]),
          "update_ms": {k: statistics.median(runs[k][2]) for k in ("consolidated", "list")},
          "compute_ms": {k: runs[k][3] for k in runs}, "list_build_groups_ms": build_groups_ms,
          "consolidated_compute_wall_ms": wall_ms, "consolidated_profiled_wall_ms": profiled_wall_ms,
          "consolidated_device_busy_ms": profile["busy_ms"],
          "consolidated_idle_share": 1 - profile["busy_ms"] / profiled_wall_ms, "consolidated_groups": profile["groups"],
          "consolidated_top": profile["top"], "checks_max_abs_diff": checks, "atol": MAP_ATOL,
          "launches_per_compute": per_compute})
    emit({"phase": "detection", "config": "iou", "nvidia_smi": smi, "values": iou_values, "timings": iou_timings,
          "checks_max_abs_diff": iou_checks, "atol": {"float64": IOU_ATOL, "cpu": MAP_ATOL}})
    emit({"phase": "detection", "config": "panoptic", "nvidia_smi": smi, "images": sub["panoptic"],
          "pq": {k: v["pq"] for k, v in pq.items()}, "update_ms": {k: v["update_ms"] for k, v in pq.items()},
          "cpu_update_ms": {k: v["update_ms"] for k, v in pq_cpu.items()},
          "tp_fp_fn": {k: [int(c.sum()) for c in v["counts"]] for k, v in pq.items()},
          "histogram_launches": launches["histogram"]})
    emit({"phase": "detection", "config": "kernel", "nvidia_smi": smi, "cases_bit_equal": checked,
          "small": small, "big": big, "launches": launches, "drive_seconds": drive_s,
          "seconds": time.perf_counter() - t_phase})
    return {
        "name": "greedy_match",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/greedy_match.cu",
        "replaces": "metrics_tpu/functional/detection/_mean_ap_kernel.py:26 (lax.scan; no Pallas kernel)",
        "launches": launches["greedy_match"],
        "max_abs_err": float(match_err),
        "ms": small["kernel_ms"],
        "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, launches["histogram"]


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
    phase_image(torch, args.seed, smi)
    torch.cuda.empty_cache()
    match, detection_histogram = phase_detection(torch, args.seed, smi)
    kernels[0]["launches"] += detection_histogram
    kernels.append(match)

    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
