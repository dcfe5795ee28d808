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
   of the same length in turns with ``torch.cumsum`` (CUB's single-pass scan), and
   ``torch.cumsum`` of the DLRM compute's two lanes in one call: as a (2, N) tensor
   along dim 1 in turns with the kernel (the library yardstick of the kernels line),
   and once as an (N, 2) tensor along dim 0; the scan per call at the ImageNet
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
    runs ``all_gather`` on the card; then PearsonCorrCoef(num_outputs=12) and
    SpearmanCorrCoef(num_outputs=12) over the QM9 rows of phase 15 (Pearson's moments
    come back stacked ``(1, 12)`` and merge through ``_final_aggregation``). Checks:
    synced values bit-equal to unsynced ones; the live states come back bit-equal after
    each synced compute, a ``CatBuffer`` still a ``CatBuffer``; a second ``sync()``
    raises. Timing: one ``sync()`` per metric.
11. sync_ranks: four processes on the one card in a ``gloo`` group (CUDA tensors,
    which gloo stages through the host), spawned after the build; each rank feeds
    its own two Cityscapes batches to the collection and its share of the MS MARCO
    updates (14, 17, 22 and 17 of the 70) to RetrievalMAP with list and
    ``cat_capacity`` states, and its share of the QM9 updates (30, 20, 25 and 25%) to
    PearsonCorrCoef and SpearmanCorrCoef (12 outputs), and syncs at ``compute``. Every
    rank's values must equal one process's run on the union in rank order (counts
    bit-equal, floats within 1e-6, Pearson's merged moments and Spearman within 1e-5),
    its list and ``cat_capacity`` values bit-equal; a rank that outlives the deadline is
    killed and the phase fails.

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
    - CIFAR-10 FID protocol, cut to 10,000 real and 10,000 generated 3x32x32 uint8 images
      (the protocol's 50,000 each) in updates of 500, resized to 299x299 inside a full-width InceptionV3 on
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
    - the kernel bit-equal to its plain version on the COCO computes' three launch
      inputs (small and big bucket, the list layout's 524288 x 64 x 64) and on D or G = 1,
      G = 1024, groups without valid rows, ties, IoUs at a threshold and area-ignored gts;
      both of its variants (forced through ``tm_greedy_match_variant``) bit-equal too at
      G = 32, 33, 64, 65, 1024, 4096, D = 1, 17, 100, triples not a multiple of a block,
      equal maxima at gts 3, 35, 36 and 40, a NaN beside a row's maximum, thresholds -0.1
      and 1.0; its event, device and back-to-back ms against the plain version (on eighths
      of the groups at the list shape) and the bound (the IoU of valid (detection, gt)
      pairs, areas and masks read once, both masks and npig written once, at 3.35 TB/s) at
      the three launch shapes; update, compute and the list layout's host
      ``_build_groups`` ms; the consolidated compute's idle share (device busy over the
      same profiled call's wall); the phase's peak of allocated memory.

15. regression_audio: regression and audio at published shapes, data drawn on the card,
    one line per configuration; every compute's launches counted with the counts at 0
    just before it:
    - NYU Depth v2, Eigen test split: 654 depth maps of 480x640 (0.7-10 m, predictions =
      target x log-normal noise) in updates of 8 maps' pixels through RMSE, AbsRel (MAPE),
      MSLE, MAE and R2, each within 1e-5 relative of float64 on the whole set; no launch;
    - QM9 test part (DimeNet's split): 10,831 molecules x 12 targets in updates of 32 through
      Pearson, Spearman, Kendall (tau-b, and tau-c with the t-test), concordance, explained
      variance and R2 (raw values), against float64 numpy and scipy's spearmanr and
      kendalltau (1e-5; Spearman and Kendall 1e-6); exactly 2 scan launches per Spearman
      compute and 1 ``kendall_pairs`` call (the merge-count chain) per Kendall compute;
      again with ``cat_capacity``, bit-equal; the chain at this
      shape bit-equal to both plain versions (all pairs, and the merge count in plain
      PyTorch), its device ms summed over every launch of a call (sort, memsets, hand
      kernels) and its bounds;
    - STS-B dev: 1,500 pairs, gold scores on multiples of 0.2: Pearson, Spearman, Kendall
      a/b/c against float64 (pair counts in numpy, scipy), the tie-run ranks equal to
      scipy's ``rankdata``; 1 ``kendall_pairs`` call per Kendall compute, its counts
      equal to numpy's and both plain versions', its times and bounds at 1,500 x 1;
    - Libri2Mix test (8 kHz, min, 3,000 mixtures x 2 speakers cut to 4 s; estimates the
      targets permuted and noised) in updates of 16: PIT on SI-SDR (the drawn permutation
      undone), SI-SNR, SNR and SDR (filter 512, float64) on the aligned estimates, against
      float64 (1e-4 dB); SDR on 50 sources within 1e-6 dB of numpy FFT + scipy's
      ``solve_toeplitz``; STOI of 200 mixtures on the host, card tensors equal to CPU ones;
      PESQ's ``ModuleNotFoundError``; the SDR update's kernel profile;
    - Kendall's merge-count chain alone at N = 131,072: bit-equal to both plain versions,
      the closed form on a ramp (8,589,869,056 concordant pairs, past 2^31), event,
      back-to-back and device ms (the whole call, split into sort, memsets and hand
      kernels), the plain ms, the bound (bytes) and the bytes of its own design,
      ``-Xptxas -v`` registers and spills; at N = 2^22, a continuous column and one of 64
      levels, the counts equal to the plain merge count's and tau-b within 1e-9 of scipy's
      kendalltau; at N = 2^24, ramp against ramp and against -ramp give the closed forms
      [[C(N, 2), 0, 0, 0]] and [[0, C(N, 2), 0, 0]] exactly; device ms of both sizes.

16. wrappers_nominal: nominal association and the five wrappers, data drawn on the card,
    every path's launches counted with the counts at 0 just before it:
    - UCI Adult: 48,842 rows x its 8 categorical columns at their cardinalities with "?"
      as a category (9, 16, 7, 15, 6, 5, 2, 42), skewed marginals, education -> occupation
      and relationship -> sex dependent, ~1% NaN in workclass, occupation and
      native-country. The four ``_matrix`` forms under both NaN strategies: exactly one
      histogram launch a call (28 pairs, 3,982 bins, 1,367,576 ids), the pair tables
      bit-equal to 28 plain per-pair counts on the card, to a CPU run of the port and to
      the per-pair tables of a numpy evaluator that densifies each pair's joint labels as
      the JAX package does; the values within 1e-6 of its float64 statistics. The four
      classes on (education, occupation) in updates of 4,096 (one launch an update each),
      their tables bit-equal to the pair launch's, their values within 1e-6 of the matrix
      entries. Timings: each form's call, the pair launch alone against the plain version,
      ``torch.bincount`` and the bound, and the 28 per-pair launches the JAX loop makes.
    - ImageNet-1k val: 50,000 x 1,000 logits (true class shifted up) in updates of 256
      through BootStrapper(MulticlassAccuracy(1000, average="macro"), 100 copies,
      quantiles 0.025 and 0.975): the copies' states after 10 updates bit-equal to a CPU
      run with the same seed, mean/std/quantile equal to the copies' values; no kernel
      launch (10^6 confusion bins take the scatter-add route); ClasswiseWrapper over
      MulticlassAccuracy(1000, average=None) bit-equal to the metric alone, MinMaxMetric
      over 10 computes equal to the running min and max of the macro values.
    - DLRM-style rows: 20 updates of 65,536 through BootStrapper(BinaryAUROC(), 20): each
      copy's rows as many as the replayed Poisson draws, its AUROC within 1e-5 of a
      float64 Mann-Whitney statistic, exactly 20 scan launches a compute.
    - QM9 with 1% NaN per target in both inputs, updates of 32, through
      MultioutputWrapper(PearsonCorrCoef(), 12): bit-equal to per-column PearsonCorrCoef
      on the NaN-free rows, within 1e-5 of float64.
    - MetricTracker over the Cityscapes collection, 3 steps of one batch: 2 histogram
      launches a step, each step's values bit-equal to the collection run alone,
      ``best_metric`` the steps' maximum.
17. engines: the launch engines, every demotion to eager failing the phase:
    - the histogram kernel's batched mode (``tm_histogram_batched``) bit-equal to its
      plain version row by row, in count, mask and f32 modes (quarter-step weights; random
      weights within 1e-5 of each bin's |w| sum), with out-of-range ids and an empty row,
      at (rows, ids a row, bins a row) = (10,000, 1, 100) (the fleet's routed update),
      (16, 65,536, 4) and (100, 256, 10^6) (100 bootstrap copies of a 1,000-class
      confusion matrix); event and device ms, the plain version, ``torch.bincount`` over
      the row-offset ids and the bound at each;
    - the JAX package's canonical five-group collection (BinaryAccuracy,
      BinaryConfusionMatrix, BinaryAUROC(thresholds=11), MeanSquaredError,
      MeanAbsoluteError) over 200 steps of 65,536 rows (the MLPerf DLRM-v2 global batch,
      drawn on the card) with ``fused=True`` and without: ``compute()`` bit-identical,
      200 replays and 0 degrades; wall per step (CUDA events, median), launches and
      device ms per step from a profiler trace, which also counts the histogram launches
      inside the replays; the JAX package's mixed collection (2 groups fused, 2 eager)
      bit-identical to eager;
    - MulticlassAccuracy(num_classes=10, average=None, fleet_size=16): 20 routed updates
      of 10,000 rows, stream 15 empty, bit-identical to 16 independent metrics fed each
      stream's rows, the batched mode launched; the JAX package's canonical fleets
      (micro accuracy, MeanSquaredError within 1e-6 relative, MaxMetric) after a routed
      and a broadcast update against independent metrics, and ``reduce_fleet`` against
      one metric on all rows; wall, launches and device ms per routed update.
18. sketches: the sketch family and the ``tolerance > 0`` tier, data drawn on the card,
    every path's launches counted with the counts at 0 just before it:
    - Criteo 1TB day 23 (the DLRM stream of phase 6, 1,361 updates of 65,536) through
      BinaryAUROC and BinaryAveragePrecision with ``tolerance=1e-3, tolerance_bits=14``,
      StreamingAUROCBound(bits=14), QuantileSketch() and HistogramDrift(num_bins=64)
      (reference the first half, live the second): 9 mask-mode histogram launches an
      update; every state bit-equal to the plain histogram of the whole stream; the exact
      AUROC and AP (the exact tier with ``cat_capacity=2**27``) inside the certified
      brackets and within width/2 of the served midpoints (1e-6 for float32 rounding);
      each quantile within ``relative_error`` (+1e-5) of the exact order statistic at rank
      ``floor(q(n-1))`` of one ``torch.sort``; update and compute ms, state bytes against
      the exact tier's buffers; the mask mode at (65,536 ids, 2^14 bins) against its plain
      version, ``torch.bincount`` and the bound;
    - 89,137,319 ids uniform in [0, 40,000,000) through DistinctCount(p=12) and (p=14):
      the estimate within 3·1.04/sqrt(m) of ``torch.unique``'s count, the uint8 registers
      bit-equal to a CPU run of the port, no kernel launch;
    - ImageNet-1k one-vs-rest (the curve phase's 50,000 x 1,000 softmax) in 196 updates of
      256 through MulticlassAUROC and MulticlassAveragePrecision (``average=None,
      tolerance=1e-2``): 2 batched-mode launches an update each, the first 3 updates'
      (1,000, 4,096) histograms bit-equal to the per-lane loop of 2,000 single launches,
      every class's exact value inside its bracket; the batched mode at (1,000, 256, 4,096)
      timed as above;
    - the three DLRM sketch-tier metrics as one ``MetricCollection(fused=True)`` over 200
      updates, bit-equal to eager, one replay an update; DistinctCount(fleet_size=16) over
      20 routed updates of 10,000 ids, bit-equal to 16 separate sketches.
19. text: the string metrics and Perplexity, no hand kernel (every launch count 0); the
    string metrics' states on the card bit-equal to the port's CPU run on the same strings,
    which runs at the same time in four worker processes (``spawn``), values within 1e-6:
    - LibriSpeech test-clean's count: 2,620 utterances of 5-35 words from a seeded
      10,000-word vocabulary (one word in 20 with punctuation, a number or a capital),
      each hypothesis its reference with ~10% substitutions, insertions and deletions,
      through WER, CER, MER, WIL and WIP in updates of 64, and each functional once on
      the whole set (equal to its class);
    - WMT14 newstest2014 en-de's count: 3,003 sentences of 5-40 words, one reference each,
      ~15% edits, through BLEU, SacreBLEU (13a, intl, char), chrF, chrF++ and TER in
      updates of 64 (intl twice: by the ``regex`` rules where ``regex`` is installed and by
      the ``unicodedata`` fallback, their counts equal), and EED on the first 300 (a cut:
      its host DP takes ~20 ms a sentence);
    - CNN/DailyMail test's summary shape (3-4 sentences of 12-18 words, ~52 tokens), the
      count cut from 11,490 to 3,000 articles, through ROUGE-1, -2, -L and -Lsum (the
      regex sentence split); without nltk, ``use_stemmer=True`` raises the JAX package's
      ``ModuleNotFoundError``;
    - SQuAD v1.1 dev's count: 10,570 questions with 1-3 gold answers, in updates of 1,000;
    - Perplexity at GPT-2 small's evaluation shape: batch 8 x context 1,024 x vocabulary
      50,257 float32 logits (1.65 GB) drawn on the card, ``ignore_index=-100`` on a seeded
      10%: within a relative 1e-5 of the port's CPU run on the same logits; the event and
      device ms of one update against the bound (the logits and targets read once at 3.35
      TB/s) and one ``cross_entropy(reduction="sum")`` call; the update through
      ``MetricCollection(fused=True)``, one replay, equal to eager.
20. model_metrics: BERTScore, InfoLM, CLIPScore and LPIPS at published widths with seeded
    weights drawn on the card (a listed cut: no published checkpoint is in the repository),
    no hand kernel (every launch count 0), texts through a seeded word-level tokenizer of
    this script (the card's machine has no ``transformers``):
    - BERTScore on roberta-large's shape (24 layers, 1,024 wide, 16 heads, FFN 4,096,
      vocabulary 50,265, 514 positions; N(0, 0.02) weights, LayerNorm 1 and 0) over the
      3,003 WMT14 pairs of the text phase, one ``compute`` with and one without idf;
    - InfoLM on bert-base-uncased's shape with its MLM head, 64 of those pairs at
      ``max_length=64`` (a cut: 512 costs 512 forwards of 512 tokens a side), the nine
      measures, one ``compute`` each;
    - CLIPScore on openai/clip-vit-large-patch14's shape over 1,000 uint8 480x640 images
      (MS-COCO 2017 val's shape; 1,000 of its 5,000, a cut) with a caption of 8-20 words
      each, in updates of 50;
    - LPIPS (He-scaled convs, lin heads |N(0, 1)|/C, written to files under ``build/`` and
      read by the metric) on 64x64 patch pairs (BAPPS's size): AlexNet and VGG16 on 10,000
      pairs, SqueezeNet-1.1 on 1,000, in updates of 100.
    Checks against the port's CPU run on the same weights and a few sentences, images or
    pairs: encoder outputs within 1e-3, BERTScore within 1e-4, InfoLM's distributions within
    1e-5 and its values within 1e-4 of max(|value|, 1) (Fisher-Rao as cos(d/2)), CLIPScore
    within 1e-2 on its 0-100 scale, ``preprocess`` within 1e-4, LPIPS within 1e-4 relative;
    counts exact (int64), an identical LPIPS pair under 1e-6. Printed: compute and update
    ms, sentences/images/pairs per second of each forward, its device ms split into GEMMs
    and convolutions, softmax and the rest, peak memory and each part's seconds.
21. ckpt_ingest: durable and coalesced state, one JSON line per check:
    - DLRM: the day-23 stream (89,137,319 rows in updates of 65,536) into one
      ``MetricCollection`` of BinaryAUROC, BinaryAUROC(max_fpr=0.1) and
      BinaryAveragePrecision at ``cat_capacity=2**27`` (one compute group, 1.07 GB of
      buffers); ``save_checkpoint(blocking=False)`` after update 680 while the updates go
      on, restored into a fresh collection that takes the rest: the three computes
      bit-equal to the uninterrupted run's, one scan launch each. Printed: the save call's
      host ms, the bytes, the writer's ms to commit, the median update ms (wall, synced)
      before and during the write, restore ms, peak memory;
    - the five-group canonical collection fused over 200 steps of 65,536 rows, a blocking
      save at step 100 (the leaders' step buffers), restored into a fused collection that
      had already stepped (its replays copy the restored states in once) and run for the
      last 100 steps: bit-equal to the uninterrupted run, one histogram launch a replay;
    - the same collection behind an ``IngestQueue`` fed by a producer thread (200
      enqueues of the same batches): after ``flush`` bit-equal to the synchronous fused
      run, ``degrades == 0``, every chained step a captured graph, one replay a tick.
      Printed: enqueue us (median, p99), ticks, replays a tick, rows/s, histogram launches
      against the replays' and the captures' warm-ups'; beside it the same enqueues into a
      queue without a tick thread (their median us; one flush, bit-equal too);
    - faults: ``fused.launch`` at rate 0.25 (seed 7) over 50 steps bit-equal to eager with
      ``degrades > 0``; one ``ingest.tick`` fault: no row lost, bit-equal; ``ckpt.fsync``
      at occurrence 0: the retry commits; a Cityscapes batch poisoned by ``input.poison``
      under ``nan_policy="raise"``: ``PoisonedInputError``, the state untouched.
    The sync_ranks phase (11) also runs the pure tier on each of its four ranks:
    ``evaluate_sharded`` of the Cityscapes collection and of a ``cat_capacity``
    BinaryAUROC over DLRM-style rows (through ``cat_sync``) against one process on the
    union, and once more with a capacity that rank 1 overflows: NaN on every rank.

The last three lines are the ``nvidia-smi`` name and power limit, the kernels JSON
line and ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""
import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
KERNEL_WRAPPERS = {  # name in the kernels line: (module, wrapper whose ``launches`` counts its kernel)
    "histogram": ("metrics_tpu_torch.ops.histogram", "histogram_cuda"),
    "histogram_batched": ("metrics_tpu_torch.ops.histogram", "histogram_batched_cuda"),
    "segment_scan": ("metrics_tpu_torch.ops.segment", "segment_scan_cuda"),
    "greedy_match": ("metrics_tpu_torch.ops.greedy_match", "greedy_match_cuda"),
    "kendall_pairs": ("metrics_tpu_torch.ops.kendall", "kendall_pairs_cuda"),
}
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
# the mapped sync: each rank's DLRM-style binary rows through evaluate_sharded into a
# cat_capacity BinaryAUROC, once with room for every rank and once where rank 1 overflows
RANK_AUROC_ROWS = (60_000, 70_000, 50_000, 65_536)
RANK_AUROC_CAPACITY = 1 << 17
RANK_AUROC_OVERFLOW_CAPACITY = 65_536
RANK_BOOTSTRAPS = 20  # copies of the stacked BootStrapper(BinaryAccuracy) each rank syncs
QM9_RANK_SHARES = (0.3, 0.2, 0.25, 0.25)  # of the QM9 updates, in rank order
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
    return {k: us for k, (_, us) in device_launches(prof).items() if us > 0}


def profile_window(torch, fn, reps: int):
    """A profiler trace of ``reps`` calls of ``fn``, recorded as the active step of a
    schedule whose warmup step makes the same calls first. A trace without the warmup
    step, late in a long process, lost the first device event of its window (a memset
    of the first call, or its kernel), so a reading that needs every launch failed."""
    fn()
    torch.cuda.synchronize()
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA], schedule=schedule) as prof:
        for _ in range(2):  # the warmup step, then the recorded one
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def kernel_device_ms(torch, fn, key: str, reps: int = 10):
    """Device ms per ``fn()`` call of the one kernel, named with ``key``, that each call
    launches. A reading counts only when the trace holds all ``reps`` of its launches:
    up to three tries, else None."""
    for _ in range(3):
        prof = profile_window(torch, fn, reps)
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and key in e.key]
        if sum(e.count for e in events) == reps:
            return sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                       for e in events) / reps / 1e3
    return None


def device_launches(prof) -> dict:
    """(launches, device microseconds) of each kernel, copy and memset in a trace, by name."""
    out = {}
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            out[evt.key] = (evt.count, us if us is not None else evt.self_cuda_time_total)
    return out


def call_device_ms(torch, fn, hand_key: str, reps: int = 10):
    """Device ms of one ``fn()`` call summed over every kernel, copy and memset it
    launches, split into the hand-written kernels (names with ``hand_key``), memsets and
    the rest (the library's sort). It counts only when the trace of ``reps`` calls holds
    ``reps`` times each launch of a trace of one call: up to three tries, else None."""
    for _ in range(3):
        one = {k: n for k, (n, _) in device_launches(profile_window(torch, fn, 1)).items()}
        many = device_launches(profile_window(torch, fn, reps))
        if not one or {k: n for k, (n, _) in many.items()} != {k: reps * n for k, n in one.items()}:
            continue
        split = {"hand_kernels_ms": 0.0, "memset_ms": 0.0, "sort_ms": 0.0}
        for name, (_, us) in many.items():
            part = "hand_kernels_ms" if hand_key in name else "memset_ms" if "Memset" in name else "sort_ms"
            split[part] += us / reps / 1e3
        return {"device_ms": sum(split.values()), **split, "launches_per_call": one}
    return None


def device_ms(torch, fn, reps: int = 10) -> dict:
    """Device ms per ``fn()`` call of each kernel and memset, by the first 70 characters
    of its name (kernels that share them summed), from a profiler trace."""
    out = {}
    for name, (_, us) in device_launches(profile_window(torch, fn, reps)).items():
        out[name[:70]] = out.get(name[:70], 0.0) + us / reps / 1e3
    return out


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

    # the kernels line's library yardstick: torch.cumsum of the same two lanes in one call,
    # as one (2, N) tensor along dim 1, in turns with the kernel; as one (N, 2) tensor along
    # dim 0 PyTorch scans the long outer dimension at seconds a call, so that form is timed once
    rows = torch.stack(lanes, 0)
    want_rows = torch.stack([torch.cumsum(lane, 0, dtype=torch.int32) for lane in lanes], 0)
    rows_cumsum = lambda: torch.cumsum(rows, 1, dtype=torch.int32)  # noqa: E731
    if not torch.equal(rows_cumsum(), want_rows):
        raise AssertionError("torch.cumsum of the (2, N) lanes differs from the lanes' cumsums")
    rows_cumsum_ms = [event_ms(torch, rows_cumsum, warmup=10)]
    pair_kernel_ms = event_ms(torch, lambda: segment_scan_cuda(lanes, None, ops, True), warmup=10)
    rows_cumsum_ms.append(event_ms(torch, rows_cumsum, warmup=10))
    columns, once = rows.T.contiguous(), []
    columns_cumsum = timed_call(torch, once, lambda: torch.cumsum(columns, 0, dtype=torch.int32))
    columns_cumsum_ms = events_ms(torch, once)[0]
    if not torch.equal(columns_cumsum, want_rows.T):
        raise AssertionError("torch.cumsum of the (N, 2) lanes differs from the lanes' cumsums")
    del rows, want_rows, columns, columns_cumsum

    # the ImageNet path's shape: one class, 50,000 rows, the same two lanes, reverse
    small, _ = sorted_run_lanes(torch, *imagenet_class)
    small_want = _plain_multi_scan(small, None, ops, True)
    if not all(torch.equal(a, b) for a, b in zip(segment_scan_cuda(small, None, ops, True), small_want)):
        raise AssertionError("scan kernel and plain version disagree at the ImageNet shape")
    small_ms = event_ms(torch, lambda: segment_scan_cuda(small, None, ops, True), reps=100, warmup=10)
    small_plain_ms = event_ms(torch, lambda: _plain_multi_scan(small, None, ops, True), reps=100, warmup=10)
    small_cumsum_ms = event_ms(torch, lambda: torch.cumsum(small[0], 0, dtype=torch.int32), reps=100, warmup=10)
    small_rows = torch.stack(small, 0)
    small_rows_cumsum_ms = event_ms(torch, lambda: torch.cumsum(small_rows, 1, dtype=torch.int32), reps=100, warmup=10)
    m = small[0].numel()
    small_bound_ms = m * k * 2 * small[0].element_size() / HBM_BYTES_PER_S * 1e3
    emit({"phase": "curve_timing", "card": smi, "metrics": timing,
          "segment_scan": {"n": n, "lanes": k, "kernel_ms": kernel_ms, "kernel_ms_first_turn": kernel_first_ms,
                           "kernel_ms_back_to_back": kernel_b2b_ms,
                           "plain_ms": plain_ms, "torch_cummin_ms": library_ms, "bound_ms": bound_ms,
                           "kernel_share_of_bound": bound_ms / kernel_ms},
          "segment_scan_sum_lane": {"n": n, "kernel_ms": sum_kernel_ms, "torch_cumsum_ms": cumsum_ms,
                                    "back_to_back": back_to_back, "bound_ms": sum_bound_ms},
          "segment_scan_two_lanes_cumsum": {"n": n, "lanes": k, "torch_cumsum_2_by_n_dim_1_ms": rows_cumsum_ms,
                                            "kernel_ms_between": pair_kernel_ms,
                                            "torch_cumsum_n_by_2_dim_0_ms_once": columns_cumsum_ms},
          "segment_scan_imagenet_shape": {"n": m, "lanes": k, "kernel_ms": small_ms, "plain_ms": small_plain_ms,
                                          "torch_cumsum_ms": small_cumsum_ms,
                                          "torch_cumsum_2_by_n_dim_1_ms": small_rows_cumsum_ms,
                                          "bound_ms": small_bound_ms}})
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
        "library_ms": statistics.median(rows_cumsum_ms),
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
        kernel[label] = {
            "n": n, "lanes": k, "ops": list(ops), "kernel_ms": event_ms(torch, call, warmup=10),
            "kernel_ms_back_to_back": back_to_back_ms(torch, call),
            "device_ms": kernel_device_ms(torch, call, "segment_scan"),
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
    from metrics_tpu_torch.regression import PearsonCorrCoef, SpearmanCorrCoef
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
        qm9 = qm9_data(torch, seed)
        c12 = qm9[0].shape[1]
        regs, regs_local = ({"PearsonCorrCoef": PearsonCorrCoef(num_outputs=c12, **kw),
                             "SpearmanCorrCoef": SpearmanCorrCoef(num_outputs=c12, **kw)} for kw in (sync, {}))
        torch.cuda.synchronize()

        zero_launches()  # ---- NCCL sync path starts
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
        for i in range(0, QM9["molecules"], QM9["batch"]):
            for metric in regs.values():
                metric.update(qm9[0][i:i + QM9["batch"]], qm9[1][i:i + QM9["batch"]])
        reg_values = {name: synced_compute(torch, m) for name, m in regs.items()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        # ---- NCCL sync path ends
        expect_launches("NCCL sync path", launches, histogram=2 * UPDATES, scan=2 + 2)

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
        # Pearson's moments come back stacked (1, 12) and merge; Spearman's cat states gather
        if regs["PearsonCorrCoef"].mean_x.shape != (c12,):
            raise AssertionError("the live Pearson moments did not come back unstacked")
        for i in range(0, QM9["molecules"], QM9["batch"]):
            for metric in regs_local.values():
                metric.update(qm9[0][i:i + QM9["batch"]], qm9[1][i:i + QM9["batch"]])
        for name, value in reg_values.items():
            local = regs_local[name].compute()
            if value.shape != (c12,) or not torch.equal(value, local):
                raise AssertionError(f"{name}: synced {value} vs unsynced {local}")
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
            "qm9_sync_ms": {name: sync_ms(torch, m, reps=3) for name, m in regs.items()},
        }
        timing["collection_sync_ms"] = sum(timing["collection_sync_ms_per_metric"].values())
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    emit({"phase": "sync_nccl", "card": smi, "backend": "nccl", "world_size": 1, "rows": sum(b[0].numel() for b in msmarco),
          "launches": launches, "synced_equal_unsynced": True, "retrieval_map": map_values["list"].item(),
          "qm9_pearson": reg_values["PearsonCorrCoef"].tolist(), "qm9_spearman": reg_values["SpearmanCorrCoef"].tolist(),
          "exact_match_rows": exact_value.numel(), "seconds_incl_updates": seconds, "timing": timing})
    return launches


def rank_cityscapes_batches(torch, seed: int, rank: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 10 + rank)
    return [cityscapes_batch(torch, g) for _ in range(RANK_BATCHES)]


def rank_msmarco_share(batches, rank: int):
    lo = sum(MSMARCO_RANK_UPDATES[:rank])
    return batches[lo:lo + MSMARCO_RANK_UPDATES[rank]]


def rank_qm9_share(qm9, rank: int):
    """This rank's updates of the QM9 rows: ``QM9_RANK_SHARES`` of the updates, in rank order."""
    n = QM9["molecules"]
    starts = list(range(0, n, QM9["batch"]))
    bounds = [round(sum(QM9_RANK_SHARES[:r]) * len(starts)) for r in range(SYNC_RANKS + 1)]
    return [(qm9[0][i:i + QM9["batch"]], qm9[1][i:i + QM9["batch"]]) for i in starts[bounds[rank]:bounds[rank + 1]]]


def rank_auroc_batches(torch, seed: int, rank: int):
    """Rank ``rank``'s binary rows (DLRM-style scores, 3% positives), in two batches."""
    g = torch.Generator(device="cuda").manual_seed(seed + 40 + rank)
    n = RANK_AUROC_ROWS[rank]
    target = (torch.rand(n, generator=g, device="cuda") < DLRM["positive_rate"]).to(torch.int32)
    scores = torch.sigmoid(torch.randn(n, generator=g, device="cuda") + DLRM["positive_shift"] * target)
    return [(scores[: n // 2], target[: n // 2]), (scores[n // 2:], target[n // 2:])]


def rank_pure(torch, seed: int, rank: int, cityscapes) -> dict:
    """This rank's share through the pure tier: ``evaluate_sharded`` of the Cityscapes
    collection and of a ``cat_capacity`` BinaryAUROC (``cat_sync``), once overflowing on
    rank 1, and a stacked BootStrapper's ``sync_state`` and ``evaluate_sharded``."""
    import torch.distributed as dist

    from metrics_tpu_torch.classification import BinaryAccuracy, BinaryAUROC
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.parallel import evaluate_sharded
    from metrics_tpu_torch.wrappers import BootStrapper

    out = {f"collection/{k}": v for k, v in evaluate_sharded(MetricCollection(collection_metrics("cuda")),
                                                            cityscapes).items()}
    binary = rank_auroc_batches(torch, seed, rank)
    out["auroc"] = evaluate_sharded(BinaryAUROC(cat_capacity=RANK_AUROC_CAPACITY), binary)
    out["auroc/overflow"] = evaluate_sharded(BinaryAUROC(cat_capacity=RANK_AUROC_OVERFLOW_CAPACITY), binary)
    # a stacked BootStrapper's pure tier: rank r takes 2 + r steps, so the seeds differ until the sync
    boot = BootStrapper(BinaryAccuracy(), RANK_BOOTSTRAPS, seed=seed, raw=True)
    state = boot.init_state()
    for i in range(2 + rank):
        state = boot.local_update(state, *binary[i % 2])
    synced = boot.sync_state(state, dist.group.WORLD)
    out["boot/seed_local"], out["boot/seed"] = state["seed"], synced["seed"]
    for name, value in state["metrics"].items():
        out[f"boot/local/{name}"], out[f"boot/synced/{name}"] = value, synced["metrics"][name]
    out.update({f"boot/value/{k}": v for k, v in evaluate_sharded(boot, binary).items()})
    return out


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
        from metrics_tpu_torch.regression import PearsonCorrCoef, SpearmanCorrCoef
        from metrics_tpu_torch.retrieval import RetrievalMAP

        collection = MetricCollection(collection_metrics("cuda"))
        check_groups(collection)
        maps = {"list": RetrievalMAP(), "cat_capacity": RetrievalMAP(cat_capacity=CAT_CAPACITY)}
        qm9 = rank_qm9_share(qm9_data(torch, seed), rank)
        regs = {"PearsonCorrCoef": PearsonCorrCoef(num_outputs=len(QM9["targets"])),
                "SpearmanCorrCoef": SpearmanCorrCoef(num_outputs=len(QM9["targets"]))}
        batches = rank_cityscapes_batches(torch, seed, rank)
        share = rank_msmarco_share(msmarco_batches(torch, seed), rank)
        torch.cuda.synchronize()
        zero_launches()  # ---- this rank's path starts
        t0 = time.perf_counter()
        for logits, target in batches:
            collection.update(logits, target)
        for preds, target, indexes in share:
            for metric in maps.values():
                metric.update(preds, target, indexes=indexes)
        for preds, target in qm9:
            for metric in regs.values():
                metric.update(preds, target)
        torch.cuda.synchronize()
        update_s, compute_s = time.perf_counter() - t0, {}
        values = {}
        for name, metric in [*collection.items(keep_base=True, copy_state=False),
                             *((f"RetrievalMAP/{kind}", m) for kind, m in maps.items()), *regs.items()]:
            t1 = time.perf_counter()
            values[name] = synced_compute(torch, metric)
            torch.cuda.synchronize()
            compute_s[name] = time.perf_counter() - t1
        launches = all_launches()
        # ---- this rank's path ends
        if not all(isinstance(getattr(maps["cat_capacity"], s), CatBuffer) for s in maps["cat_capacity"]._defaults):
            raise AssertionError("unsync did not restore the CatBuffer states")
        pure, pure_launches, pure_s = run_counted(torch, lambda: rank_pure(torch, seed, rank, batches))
        torch.save({"values": {k: v.cpu() for k, v in values.items()}, "launches": launches,
                    "pure": {k: v.cpu() for k, v in pure.items()}, "pure_launches": pure_launches,
                    "pure_s": pure_s,
                    "rows": sum(b[0].numel() for b in share), "update_s": update_s, "compute_s": compute_s},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_sync_ranks(torch, seed: int, smi: str):
    """Four ranks on the one card in a gloo group: each feeds its own Cityscapes
    batches and MS MARCO and QM9 shares, syncs at ``compute``, and must equal one
    process run on the union of the data in rank order."""
    import shutil

    import torch.multiprocessing as mp

    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.regression import PearsonCorrCoef, SpearmanCorrCoef
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
    qm9 = qm9_data(torch, seed)
    for name, make in (("PearsonCorrCoef", PearsonCorrCoef), ("SpearmanCorrCoef", SpearmanCorrCoef)):
        metric = make(num_outputs=qm9[0].shape[1])
        for rank in range(SYNC_RANKS):
            for preds, target in rank_qm9_share(qm9, rank):
                metric.update(preds, target)
        want[name] = metric.compute().cpu()

    worst, bit_equal, pearson_worst = 0.0, True, 0.0
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
            if name == "PearsonCorrCoef":  # merged moments: 1e-5
                pearson_worst = max(pearson_worst, err)
                if mine.shape != value.shape or err > 1e-5:
                    raise AssertionError(f"rank {rank}: {name} {mine} vs {value} on the union")
                continue
            if name == "SpearmanCorrCoef" and not torch.equal(mine, value):  # gathered rows in rank order
                raise AssertionError(f"rank {rank}: {name} {mine} vs {value} on the union")
            worst, bit_equal = max(worst, err), bit_equal and torch.equal(mine, value)
            if err > 1e-6:
                raise AssertionError(f"rank {rank}: {name} {mine} vs {value} on the union")
    launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
    expect_launches("the ranks", launches, histogram=SYNC_RANKS * 2 * RANK_BATCHES, scan=SYNC_RANKS * (2 + 2))

    # the mapped sync: each rank's evaluate_sharded against the union
    auroc = BinaryAUROC()
    for rank in range(SYNC_RANKS):
        for scores, target in rank_auroc_batches(torch, seed, rank):
            auroc.update(scores, target)
    want_auroc = auroc.compute().cpu()
    pure_worst = 0.0
    for rank, result in enumerate(results):
        pure = result["pure"]
        for name, value in want.items():
            if name in ("RetrievalMAP", "PearsonCorrCoef", "SpearmanCorrCoef"):
                continue
            mine = pure[f"collection/{name}"]
            if not value.is_floating_point():
                if mine.dtype != value.dtype or not torch.equal(mine, value):
                    raise AssertionError(f"rank {rank}: evaluate_sharded {name} differs from the union")
                continue
            pure_worst = max(pure_worst, (mine.double() - value.double()).abs().max().item())
        pure_worst = max(pure_worst, abs(pure["auroc"].item() - want_auroc.item()))
        if pure_worst > 1e-6:
            raise AssertionError(f"rank {rank}: evaluate_sharded off the union by {pure_worst}")
        if not bool(torch.isnan(pure["auroc/overflow"])):
            raise AssertionError(f"rank {rank}: rank 1's overflow did not poison the synced AUROC")
    # the stacked BootStrapper: every rank's synced stack is the sum of the ranks' stacks, one seed
    seeds = [int(r["pure"]["boot/seed_local"]) for r in results]
    names = [k[len("boot/local/"):] for k in results[0]["pure"] if k.startswith("boot/local/")]
    for rank, result in enumerate(results):
        pure = result["pure"]
        for name in names:
            if not torch.equal(pure[f"boot/synced/{name}"], sum(r["pure"][f"boot/local/{name}"] for r in results)):
                raise AssertionError(f"rank {rank}: the synced BootStrapper {name} is not the sum of the ranks'")
        if int(pure["boot/seed"]) != max(seeds) or not torch.equal(pure["boot/value/raw"],
                                                                   results[0]["pure"]["boot/value/raw"]):
            raise AssertionError(f"rank {rank}: BootStrapper seed {int(pure['boot/seed'])} of {seeds}, or its"
                                 " evaluate_sharded value differs between ranks")
    if len(set(seeds)) != SYNC_RANKS:
        raise AssertionError(f"the ranks' BootStrapper seeds before the sync: {seeds}")
    emit({"phase": "sync_ranks_bootstrapper", "card": smi, "backend": "gloo", "world_size": SYNC_RANKS,
          "num_bootstraps": RANK_BOOTSTRAPS, "synced_equals_sum_of_ranks": True, "seeds_before_sync": seeds,
          "seed_after_sync": max(seeds), "mean": float(results[0]["pure"]["boot/value/mean"])})
    pure_launches = {k: sum(r["pure_launches"][k] for r in results) for k in results[0]["pure_launches"]}
    if pure_launches["histogram"] < 1 or pure_launches["segment_scan"] < 1:
        raise AssertionError(f"evaluate_sharded never reached the kernels: {pure_launches}")
    emit({"phase": "sync_ranks_pure", "card": smi, "backend": "gloo", "world_size": SYNC_RANKS,
          "max_abs_err_vs_union": pure_worst, "overflow_poisoned": True, "launches": pure_launches,
          "auroc_rows_per_rank": list(RANK_AUROC_ROWS), "capacity": RANK_AUROC_CAPACITY,
          "overflow_capacity": RANK_AUROC_OVERFLOW_CAPACITY, "seconds_per_rank": [r["pure_s"] for r in results]})
    for key, value in pure_launches.items():
        launches[key] += value
    emit({"phase": "sync_ranks", "card": smi, "backend": "gloo", "world_size": SYNC_RANKS,
          "msmarco_rows_per_rank": [r["rows"] for r in results], "launches": launches,
          "max_abs_err_vs_union": worst, "bit_equal_to_union": bit_equal, "pearson_max_abs_err_vs_union": pearson_worst,
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
    dev = kernel_device_ms(torch, call, "histogram")
    return {"n": n, "bins": bins, "kernel_ms": event_ms(torch, call, warmup=10),
            "kernel_ms_back_to_back": back_to_back_ms(torch, call), "device_ms": dev,
            "plain_ms": event_ms(torch, lambda: _plain_bincount(ids, weights, bins), reps=3, warmup=1),
            "torch_bincount_ms": event_ms(torch, lib, reps=5, warmup=2), "bound_ms": bound_ms,
            "kernel_share_of_bound": bound_ms / dev if dev else None, "max_abs_err": max_abs_err}


def kernel_wrappers() -> dict:
    """Each hand kernel's wrapper, by its name in the kernels line."""
    import importlib

    return {name: getattr(importlib.import_module(module), attr) for name, (module, attr) in KERNEL_WRAPPERS.items()}


def all_launches() -> dict:
    """The launch count of every kernel wrapper."""
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}


def zero_launches() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def run_counted(torch, fn):
    """``fn()`` with every launch count set to 0 just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, all_launches(), seconds


def expect_launches(label: str, got: dict, histogram: int = 0, scan: int = 0, greedy: int = 0,
                    kendall: int = 0, batched: int = 0) -> None:
    want = {"histogram": histogram, "histogram_batched": batched, "segment_scan": scan, "greedy_match": greedy,
            "kendall_pairs": kendall}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


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
# the network, in updates of 500; cut to 25,000 each when the wrappers and nominal phase
# came, and to 10,000 each when the checkpoint and ingest phase came, so that the whole
# run stays near half its time limit
CIFAR10 = {"real": 10_000, "fake": 10_000, "batch": 500, "size": 32}
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


EDGE_THRESHOLDS = (-0.1, 0.0, 0.5, 0.75, 1.0)
# (N, D, G): G at each side of the narrow variant's one and two mask words and of the
# warp variant's lane words, D not a multiple of 16, N * A * T not a multiple of a block
MATCH_EDGE_SHAPES = ((33, 17, 32), (33, 17, 33), (7, 100, 64), (7, 100, 65), (5, 1, 1024), (3, 17, 4096),
                     (31, 1, 33), (1700, 16, 16))


def match_edges(torch, g, shape, ranges):
    """``match_case`` at ``shape`` with the edge thresholds, equal maxima at gts 3, 35, 36
    and 40 of group 0 (the first must win: across mask words and warp lanes) and a NaN
    beside the maximum of the last group's first row."""
    n, _, g_count = shape
    iou, d_area, g_area, dv, gv = match_case(torch, g, *shape)
    if g_count >= 41:
        ties = [3, 35, 36, 40]
        iou[0, :, ties] = 0.875
        gv[0, ties] = True
        g_area[0, ties] = 500.0
    iou[n - 1, 0, :] = 0.25
    iou[n - 1, 0, 5] = float("nan")
    iou[n - 1, 0, g_count - 1] = 0.95
    dv[n - 1, 0] = True
    gv[n - 1, [5, g_count - 1]] = True
    thresholds = torch.tensor(EDGE_THRESHOLDS, dtype=torch.float32, device="cuda")
    return iou, d_area, g_area, dv, gv, thresholds, ranges


def match_call(torch, lib, args, variant=None):
    """One greedy-match launch of ``lib`` (a build of ``greedy_match.cu``) on ``args``,
    outside the wrapper and its count: ``tm_greedy_match``, or with ``variant`` (0 narrow,
    1 warp) ``tm_greedy_match_variant``. Returns a function that launches it and returns
    the CUDA error, and the three outputs it writes."""
    n, d, g = args[0].shape
    t, a = args[5].shape[0], args[6].shape[0]
    outs = [torch.empty((n, a, t, d), dtype=torch.bool, device="cuda") for _ in range(2)]
    outs.append(torch.empty((n, a), dtype=torch.int32, device="cuda"))
    ptrs = [x.data_ptr() for x in args] + [n, d, g, t, a] + [o.data_ptr() for o in outs]

    def run() -> int:
        stream = torch.cuda.current_stream().cuda_stream
        if variant is None:
            return lib.tm_greedy_match(*ptrs, stream)
        return lib.tm_greedy_match_variant(*ptrs, stream, variant)
    return run, outs


def match_diff(label: str, got, want) -> int:
    """The largest difference of the three outputs; raises unless bit-equal."""
    err = 0
    for name, a, b in zip(("det_matched", "det_ignored", "npig"), got, want):
        diff = 0 if a.dtype == b.dtype and a.equal(b) else int((a.int() - b.int()).abs().max())
        err = max(err, diff)
        if a.dtype != b.dtype or diff:
            raise AssertionError(f"greedy match kernel != plain at {label}: {name}")
    return err


def match_timing(torch, args, label: str, plain_slices: int = 1) -> dict:
    """Times of the kernel and its plain version on one launch's inputs, the two outputs
    held bit-equal, and the peak of memory allocated meanwhile. With ``plain_slices`` the
    plain version runs on that many slices of the groups (each group is independent)
    and its outputs are concatenated: its (N, A, D, G) intermediate is A times the IoU."""
    from metrics_tpu_torch.ops.greedy_match import _plain_greedy_match, greedy_match_cuda

    torch.cuda.reset_peak_memory_stats()
    call = lambda: greedy_match_cuda(*args)  # noqa: E731
    step = -(-args[0].shape[0] // plain_slices)

    def plain():
        parts = [_plain_greedy_match(*(x[i:i + step] for x in args[:5]), *args[5:])
                 for i in range(0, args[0].shape[0], step)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = kernel_device_ms(torch, call, "greedy_match")
    bound_ms = match_bytes(args[0], args[3], args[4], args[5], args[6]) / HBM_BYTES_PER_S * 1e3
    out = {"shape": label, "kernel_ms": event_ms(torch, call, warmup=5), "device_ms": dev,
           "kernel_ms_back_to_back": back_to_back_ms(torch, call), "bound_ms": bound_ms,
           "kernel_share_of_bound": bound_ms / dev if dev else None}
    got = call()
    want = plain()
    out["bit_equal"] = match_diff(label, got, want) == 0
    del got, want
    out["plain_ms"] = event_ms(torch, plain, reps=3, warmup=1)
    out["plain_slices"] = plain_slices
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def check_match_kernel(torch, cases) -> tuple:
    """Each (label, args) case through the kernel's wrapper and, forced, through each of
    its variants that takes it, against the plain version on the card, the three outputs
    bit-equal; returns the number of cases and the largest difference."""
    from metrics_tpu_torch import _build
    from metrics_tpu_torch.ops.greedy_match import _plain_greedy_match, greedy_match_cuda

    lib = _build.load("greedy_match")
    err = 0
    for label, args in cases:
        want = _plain_greedy_match(*args)
        err = max(err, match_diff(label, greedy_match_cuda(*args), want))
        n, d, g = args[0].shape
        for variant in (0, 1):
            run, got = match_call(torch, lib, args, variant)
            code = run()
            torch.cuda.synchronize()
            if variant == 0 and not (g <= 64 and d <= 128):
                if code == 0:
                    raise AssertionError(f"the narrow variant took {label}")
                continue
            if code != 0:
                raise AssertionError(f"variant {variant} at {label}: CUDA error {code}")
            err = max(err, match_diff(f"{label} variant {variant}", got, want))
    return len(cases), err


def phase_detection(torch, seed: int, smi: str):
    """COCO 2017 val detection through mAP (both layouts, segm), the IoU family and panoptic quality."""
    import numpy as np

    from metrics_tpu_torch.functional.detection._mean_ap_device import plan_buckets
    from metrics_tpu_torch.ops import greedy_match as gm
    from metrics_tpu_torch.ops.greedy_match import greedy_match_cuda

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
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
    torch.cuda.synchronize()
    zero_launches()  # before the recorder stands in for the wrapper in its module
    recorder = RecordingMatch(greedy_match_cuda)
    gm.greedy_match_cuda = recorder
    t0 = time.perf_counter()
    try:
        runs = {"consolidated": run_map(torch, data, 0, B, "consolidated")}
        runs["list"] = run_map(torch, data, 0, B, "list")
        recorder.keep = False
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
    launches = all_launches()
    per_compute = {name: run[4] for name, run in runs.items()}
    for name, got in per_compute.items():
        if got != (2 if name.startswith("consolidated") else 1):
            raise AssertionError(f"{name}: {got} greedy-match launches in its compute")
    expect_launches(f"detection (per compute {per_compute})", launches, histogram=2 * sub["panoptic"],
                    greedy=sum(per_compute.values()))

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
    if len(recorder.calls) != 3:
        raise AssertionError(f"{len(recorder.calls)} recorded greedy-match calls, not small, big and list")
    cases = [("COCO small bucket", recorder.calls[0]), ("COCO big bucket", recorder.calls[1])]
    for shape in ((7, 1, 9), (5, 9, 1), (3, 1, 1), (9, 20, 1024), (33, 13, 40), (4096, 16, 16)):
        cases.append(("x".join(map(str, shape)), (*match_case(torch, g, *shape), thresholds, ranges)))
    for shape in MATCH_EDGE_SHAPES:
        cases.append(("x".join(map(str, shape)) + " edges", match_edges(torch, g, shape, ranges)))
    checked, match_err = check_match_kernel(torch, cases)
    del cases

    # ---- timings (each also holds that launch's outputs bit-equal to the plain version);
    # the list layout's launch first, with nothing else held: its inputs are the largest
    # tensors of the phase, and its plain version runs on eighths of them
    peak_bytes = torch.cuda.max_memory_allocated()
    label = lambda args: "x".join(map(str, args[0].shape))  # noqa: E731
    listed_args = recorder.calls.pop()
    torch.cuda.empty_cache()
    list_timing = match_timing(torch, listed_args, label(listed_args), plain_slices=8)
    del listed_args
    torch.cuda.empty_cache()
    small = match_timing(torch, recorder.calls[0], label(recorder.calls[0]))
    big = match_timing(torch, recorder.calls[1], label(recorder.calls[1]))
    checked += 1  # the list layout's launch, held bit-equal in its timing
    recorder.calls.clear()
    peak_bytes = max(peak_bytes, *(t["peak_bytes"] for t in (list_timing, small, big)))

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
          "small": small, "big": big, "list": list_timing, "launches": launches, "drive_seconds": drive_s,
          "peak_bytes": max(peak_bytes, torch.cuda.max_memory_allocated()), "seconds": time.perf_counter() - t_phase})
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


# ------------------------------------------------------------------ regression_audio

# NYU Depth v2, Eigen test split (monocular-depth evaluation): 654 depth maps of 480x640
# in metres, capped at 10 m; predictions = target x log-normal noise; updates of 8 maps
NYU = {"maps": 654, "height": 480, "width": 640, "batch": 8, "min_m": 0.7, "max_m": 10.0, "log_sigma": 0.1}
# QM9, DimeNet's split, test part: 10,831 molecules x the 12 targets (mu, alpha, homo,
# lumo, gap, r2, zpve, U0, U, H, G, Cv), each at its dataset mean and spread; updates of 32
QM9 = {"molecules": 10_831, "batch": 32, "noise": 0.1, "cat_capacity": 16_384,
       "targets": ((2.7, 1.5), (75.2, 8.2), (-0.24, 0.022), (0.012, 0.047), (0.25, 0.047), (1190.0, 280.0),
                   (0.149, 0.033), (-411.5, 40.1), (-411.5, 40.1), (-411.5, 40.1), (-411.5, 40.1), (31.6, 4.1))}
# STS-B dev (sentence-similarity evaluation): 1,500 pairs, gold scores on multiples of 0.2
# in [0, 5]; predictions a model's cosine similarities; updates of 64
STSB = {"pairs": 1_500, "batch": 64, "step": 0.2, "noise": 0.15}
# Kendall's chain alone: random values, and preds = target = arange (concordant past 2^31);
# at scale, where the all-pairs form cannot go: tau-b against scipy, and the ramp's closed forms
KENDALL_ALONE = {"rows": 131_072, "rows_at_scale": 1 << 22, "rows_closed_form": 1 << 24}
KENDALL_SCALE_ATOL = 1e-9  # tau-b from the exact counts (float64) against scipy's kendalltau
# Libri2Mix test, 8 kHz, min mode (two-speaker separation): 3,000 mixtures x 2 speakers,
# cut to 4 s; estimates = the targets with their speakers permuted, plus noise; updates of 16
LIBRI2MIX = {"mixtures": 3_000, "speakers": 2, "samples": 32_000, "fs": 8_000, "batch": 16, "noise": 0.25,
             "sdr_filter": 512, "sdr_seconds": 30.0, "sdr_reference_sources": 50, "stoi_mixtures": 200}
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet), the bound's rate on
# purpose: it counts an FMA as two operations, so a lone subtraction issues at half of it
F32_PEAK_OPS_PER_S = 67e12
NYU_REL = 1e-5  # each error metric against float64 on the whole set, relative
QM9_ATOL = 1e-5  # correlations, explained variance and R2 against float64 (float32 running sums)
TAU_ATOL = 1e-6  # Kendall and Spearman (exact counts and ranks, float32 results) against float64
SDR_ATOL_DB = 1e-6  # the card's float64 SDR against numpy FFT + scipy solve_toeplitz
SNR_ATOL_DB = 1e-4  # SNR, SI-SNR, SI-SDR (float32 sums) against float64


def counted_computes(torch, metrics: dict) -> tuple:
    """Each metric's ``compute`` with every launch count at 0 just before it and read just
    after: the values and the launches of each kernel in each."""
    values, launches = {}, {}
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        zero_launches()
        values[name] = metric.compute()
        torch.cuda.synchronize()
        launches[name] = all_launches()
    return values, launches


def nyu_data(torch, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 400)
    shape = (NYU["maps"], NYU["height"], NYU["width"])
    target = NYU["min_m"] + (NYU["max_m"] - NYU["min_m"]) * torch.rand(shape, generator=g, device="cuda")
    preds = target * torch.exp(NYU["log_sigma"] * torch.randn(shape, generator=g, device="cuda"))
    return preds, target


def nyu_reference(torch, preds, target) -> dict:
    """RMSE, AbsRel (MAPE), MSLE, MAE and R2 over the whole set, in float64 on the card."""
    sums = dict.fromkeys(("se", "ape", "sle", "ae", "t", "t2"), 0.0)
    for i in range(0, preds.shape[0], NYU["batch"]):
        p, t = preds[i:i + NYU["batch"]].double(), target[i:i + NYU["batch"]].double()
        sums["se"] += float(((p - t) ** 2).sum())
        sums["ape"] += float(((p - t).abs() / t.abs()).sum())
        sums["sle"] += float(((torch.log1p(p) - torch.log1p(t)) ** 2).sum())
        sums["ae"] += float((p - t).abs().sum())
        sums["t"] += float(t.sum())
        sums["t2"] += float((t * t).sum())
    n = preds.numel()
    tss = sums["t2"] - sums["t"] ** 2 / n
    return {"MeanSquaredError": (sums["se"] / n) ** 0.5, "MeanAbsolutePercentageError": sums["ape"] / n,
            "MeanSquaredLogError": sums["sle"] / n, "MeanAbsoluteError": sums["ae"] / n,
            "R2Score": 1 - sums["se"] / tss}


def nyu_metrics(device="cuda"):
    from metrics_tpu_torch.regression import (
        MeanAbsoluteError,
        MeanAbsolutePercentageError,
        MeanSquaredError,
        MeanSquaredLogError,
        R2Score,
    )

    return {"MeanSquaredError": lambda: MeanSquaredError(squared=False, device=device),
            "MeanAbsolutePercentageError": lambda: MeanAbsolutePercentageError(device=device),
            "MeanSquaredLogError": lambda: MeanSquaredLogError(device=device),
            "MeanAbsoluteError": lambda: MeanAbsoluteError(device=device),
            "R2Score": lambda: R2Score(device=device)}


def ra_nyu(torch, seed: int, smi: str) -> dict:
    """NYU Depth v2's Eigen test split through five error metrics; no kernel launches."""
    preds, target = nyu_data(torch, seed)
    makers = nyu_metrics()
    metrics = {name: make() for name, make in makers.items()}
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for i in range(0, NYU["maps"], NYU["batch"]):  # each update: the batch's pixels, flattened
        for metric in metrics.values():
            metric.update(preds[i:i + NYU["batch"]].reshape(-1), target[i:i + NYU["batch"]].reshape(-1))
    values = {name: float(m.compute()) for name, m in metrics.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    if any(launches.values()):
        raise AssertionError(f"NYU evaluation launched {launches}; no hand kernel is on its path")
    want = nyu_reference(torch, preds, target)
    rel = {name: abs(values[name] - want[name]) / abs(want[name]) for name in want}
    for name, err in rel.items():
        if not err <= NYU_REL:
            raise AssertionError(f"NYU {name}: {values[name]} vs float64 {want[name]} (relative {err})")
    batch = (preds[:NYU["batch"]].reshape(-1), target[:NYU["batch"]].reshape(-1))
    update_ms = {name: event_ms(torch, lambda m=make(): m.update(*batch), reps=10) for name, make in makers.items()}
    emit({"phase": "regression_audio", "config": "nyu_depth_v2", "nvidia_smi": smi, "maps": NYU["maps"],
          "pixels": preds.numel(), "values": values, "float64": want, "max_rel_err": max(rel.values()),
          "rel_tol": NYU_REL, "update_ms_batch_8": update_ms, "seconds_incl_updates": seconds, "launches": launches})
    return launches


def qm9_data(torch, seed: int, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed + 500)
    n = QM9["molecules"]
    loc = torch.tensor([m for m, _ in QM9["targets"]], device=device)
    scale = torch.tensor([s for _, s in QM9["targets"]], device=device)
    target = loc + scale * torch.randn(n, len(loc), generator=g, device=device)
    preds = target + QM9["noise"] * scale * torch.randn(n, len(loc), generator=g, device=device)
    return preds, target


def qm9_metrics(num_outputs: int, device="cuda", **cat):
    from metrics_tpu_torch.regression import (
        ConcordanceCorrCoef,
        ExplainedVariance,
        KendallRankCorrCoef,
        PearsonCorrCoef,
        R2Score,
        SpearmanCorrCoef,
    )

    return {
        "PearsonCorrCoef": PearsonCorrCoef(num_outputs=num_outputs, device=device),
        "SpearmanCorrCoef": SpearmanCorrCoef(num_outputs=num_outputs, device=device, **cat),
        "KendallRankCorrCoef_b": KendallRankCorrCoef(num_outputs=num_outputs, device=device, **cat),
        "KendallRankCorrCoef_c_t_test": KendallRankCorrCoef(variant="c", t_test=True, num_outputs=num_outputs,
                                                            device=device, **cat),
        "ConcordanceCorrCoef": ConcordanceCorrCoef(num_outputs=num_outputs, device=device),
        "ExplainedVariance": ExplainedVariance(multioutput="raw_values", device=device),
        "R2Score": R2Score(num_outputs=num_outputs, multioutput="raw_values", device=device),
    }


def kendall_p_reference(np, tau, n: int):
    """The JAX package's normal-approximation two-sided p-value, float64 (scipy's norm)."""
    from scipy.stats import norm

    z = np.asarray(tau, np.float64) / np.sqrt((2 * (2 * n + 5)) / (9 * n * (n - 1)))
    return 2 * norm.sf(np.abs(z))


def correlation_references(np, x, y) -> dict:
    """Float64 references of every column of x, y (N, C): numpy, scipy's spearmanr and kendalltau."""
    from scipy.stats import kendalltau, spearmanr

    cols = range(x.shape[1])
    mx, my = x.mean(0), y.mean(0)
    vx, vy = x.var(0, ddof=1), y.var(0, ddof=1)
    cov = ((x - mx) * (y - my)).sum(0) / (len(x) - 1)
    pearson = cov / np.sqrt(vx * vy)
    tau_c = np.array([kendalltau(x[:, j], y[:, j], variant="c")[0] for j in cols])
    resid = y - x
    ev_num = resid.var(0)
    return {
        "PearsonCorrCoef": pearson,
        "SpearmanCorrCoef": np.array([spearmanr(x[:, j], y[:, j])[0] for j in cols]),
        "KendallRankCorrCoef_b": np.array([kendalltau(x[:, j], y[:, j])[0] for j in cols]),
        "KendallRankCorrCoef_c_t_test": (tau_c, kendall_p_reference(np, tau_c, len(x))),
        "ConcordanceCorrCoef": 2 * cov / (vx + vy + (mx - my) ** 2),
        "ExplainedVariance": 1 - ev_num / y.var(0),
        "R2Score": 1 - (resid ** 2).sum(0) / ((y - my) ** 2).sum(0),
    }


def max_err(np, got, want) -> float:
    if isinstance(want, tuple):
        return max(max_err(np, g, w) for g, w in zip(got, want))
    got = got.double().cpu().numpy() if hasattr(got, "cpu") else np.asarray(got, np.float64)
    return float(np.max(np.abs(got - np.asarray(want, np.float64))))


def kendall_bounds(n: int, c: int) -> dict:
    """The merge-count chain's bound at ``n`` rows and ``c`` columns (each input read once,
    each output written once, at 3.35 TB/s), the bytes its own design moves, and the
    all-pairs bound (two float32 subtractions a pair at 67 TFLOP/s)."""
    from metrics_tpu_torch.ops.kendall import MERGE_TILE, KendallPairsKernel

    stride = max(1, -(-n // MERGE_TILE)) * MERGE_TILE
    passes = KendallPairsKernel.merge_passes(n)
    design = {  # bytes of each step, from the shapes
        "keys": (8 + 8) * n * c,  # x, y in; packed key out
        "sort": 8 * 2 * 16 * n * c,  # 8 radix passes of 8-bit digits over 64-bit keys and 64-bit indices
        "tile_pass": 8 * n * c + 2 * 4 * stride * c,  # keys in; sorted tiles (and the pad key) out
        "merge_passes": passes * 2 * 4 * stride * c,
        "tie_runs": (8 + 4) * n * c,
    }
    function_bytes = 8 * n * c + 32 * c
    return {"bound_ms": function_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "function_bytes": function_bytes,
            "merge_passes": passes, "design_bytes": design,
            "design_bytes_ms": sum(design.values()) / HBM_BYTES_PER_S * 1e3,
            "all_pairs_bound_ms": 2 * n * (n - 1) / 2 * c / F32_PEAK_OPS_PER_S * 1e3}


def kendall_chain_timing(torch, x, y, reps: int = 10) -> dict:
    """The merge-count chain on ``x, y`` (N, C): bit-equal to both plain versions, its
    event and back-to-back ms, the device ms of a whole call (sort, memsets and the hand
    kernels, every launch of every rep in the trace) and its bounds."""
    from metrics_tpu_torch.ops.kendall import _plain_merge_pair_counts, _plain_pair_counts, kendall_pairs_cuda

    call = lambda: kendall_pairs_cuda(x, y)  # noqa: E731
    got = call()
    want, want_merge = _plain_pair_counts(x, y), _plain_merge_pair_counts(x, y)
    err = max((got - want).abs().max().item(), (got - want_merge).abs().max().item())
    if err != 0:
        raise AssertionError(f"kendall merge chain {got.tolist()} != plain {want.tolist()} / {want_merge.tolist()}")
    n, c = x.shape
    dev = call_device_ms(torch, call, "kendall", reps=reps)
    bounds = kendall_bounds(n, c)
    return {"rows": n, "columns": c, "max_abs_err": err, "kernel_ms": event_ms(torch, call),
            "kernel_ms_back_to_back": back_to_back_ms(torch, call), "device": dev,
            "kernel_share_of_bound": bounds["bound_ms"] / dev["device_ms"] if dev else None,
            "plain_merge_ms": event_ms(torch, lambda: _plain_merge_pair_counts(x, y), reps=3, warmup=1), **bounds}


def qm9_kernel_timing(torch, preds, target) -> dict:
    """The launches of a QM9 compute timed alone: Spearman's two scans over the packed
    (24 columns x 10,831 rows) positions against the plain version, ``torch.cummin`` and
    the bound; Kendall's merge-count chain over the 12 columns against both plain
    versions and its bounds. Outputs held equal to the plain versions'."""
    from metrics_tpu_torch.ops.kendall import _plain_pair_counts
    from metrics_tpu_torch.ops.rank import _tie_runs
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    _, _, new_run, is_last, pos = _tie_runs(torch.cat([preds, target], 1))
    n = pos.numel()
    scans = {}
    for name, flags, op, reverse in (("forward_min", new_run, "min", False), ("reverse_max", is_last, "max", True)):
        call = lambda f=flags, o=op, r=reverse: segment_scan_cuda((pos,), f, (o,), r)  # noqa: E731
        if not torch.equal(call()[0], _plain_multi_scan((pos,), flags, (op,), reverse)[0]):
            raise AssertionError(f"segment scan kernel != plain on Spearman's {name} lane")
        dev = kernel_device_ms(torch, call, "segment_scan")
        bound = (4 + 1 + 4) * n / HBM_BYTES_PER_S * 1e3  # position in, flag in, run bound out
        scans[name] = {"rows": n, "kernel_ms": event_ms(torch, call), "kernel_ms_back_to_back": back_to_back_ms(torch, call),
                       "device_ms": dev, "bound_ms": bound, "kernel_share_of_bound": bound / dev if dev else None,
                       "plain_ms": event_ms(torch, lambda f=flags, o=op, r=reverse: _plain_multi_scan((pos,), f, (o,), r),
                                            reps=5, warmup=1),
                       "torch_cummin_ms": event_ms(torch, lambda: torch.cummin(pos, 0))}
    m, c = preds.shape
    pairs = kendall_chain_timing(torch, preds, target, reps=10)
    pairs["plain_ms"] = event_ms(torch, lambda: _plain_pair_counts(preds, target), reps=3, warmup=1)
    return {"spearman_scans": scans, "kendall_pairs": pairs}


def ra_qm9(torch, seed: int, smi: str) -> tuple:
    """QM9's test part through the correlations (Spearman on the scan, Kendall on the pair
    kernel, exact launches per compute), with list and cat_capacity states. Returns the
    launches and the pair kernel's largest difference from its plain version."""
    import numpy as np

    preds, target = qm9_data(torch, seed)
    c = preds.shape[1]
    runs, launches, seconds = {}, {}, {}
    for kind, cat in (("list", {}), ("cat_capacity", {"cat_capacity": QM9["cat_capacity"]})):
        metrics = qm9_metrics(c, **cat)
        if cat:
            metrics = {k: v for k, v in metrics.items() if "Spearman" in k or "Kendall" in k}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, QM9["molecules"], QM9["batch"]):
            for metric in metrics.values():
                metric.update(preds[i:i + QM9["batch"]], target[i:i + QM9["batch"]])
        torch.cuda.synchronize()
        seconds[kind] = time.perf_counter() - t0
        runs[kind], launches[kind] = counted_computes(torch, metrics)
        runs[kind + "_metrics"] = metrics
    for kind in ("list", "cat_capacity"):
        for name, got in launches[kind].items():
            expect_launches(f"QM9 {kind} {name}", got, scan=2 if "Spearman" in name else 0,
                            kendall=1 if "Kendall" in name else 0)
        if kind == "cat_capacity":
            for name, value in runs[kind].items():
                same = all(torch.equal(a, b) for a, b in zip(value, runs["list"][name])) if isinstance(value, tuple) \
                    else torch.equal(value, runs["list"][name])
                if not same:
                    raise AssertionError(f"QM9 {name}: cat_capacity {value} vs list {runs['list'][name]}")
    want = correlation_references(np, preds.double().cpu().numpy(), target.double().cpu().numpy())
    errs = {name: max_err(np, runs["list"][name], w) for name, w in want.items()}
    for name, err in errs.items():
        tol = TAU_ATOL if ("Kendall" in name or "Spearman" in name) else QM9_ATOL
        if not err <= tol:
            raise AssertionError(f"QM9 {name}: {runs['list'][name]} vs float64 {want[name]} (max |err| {err})")
    compute_ms = {name: compute_timing(torch, m)["ms"] for name, m in runs["list_metrics"].items()}
    compute_ms.update({f"{name}/cat_capacity": compute_timing(torch, m)["ms"]
                       for name, m in runs["cat_capacity_metrics"].items()})
    kernels = qm9_kernel_timing(torch, preds, target)
    total = {k: sum(sum(v[k] for v in launches[kind].values()) for kind in launches)
             for k in ("segment_scan", "kendall_pairs")}
    emit({"phase": "regression_audio", "config": "qm9", "nvidia_smi": smi, "molecules": QM9["molecules"],
          "targets": c, "values": {k: (v.tolist() if not isinstance(v, tuple) else [x.tolist() for x in v])
                                   for k, v in runs["list"].items()},
          "max_abs_err_vs_float64": errs, "atol": {"correlations": QM9_ATOL, "ranks": TAU_ATOL},
          "launches_per_compute": launches["list"], "cat_capacity_bit_equal": True, "compute_ms": compute_ms,
          "kernels_at_this_shape": kernels,
          "update_seconds": seconds, "launches": total})
    return total, kernels["kendall_pairs"]["max_abs_err"]


def stsb_data(torch, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 600)
    n, step = STSB["pairs"], STSB["step"]
    latent = 5 * torch.rand(n, generator=g, device="cuda")
    gold = torch.round(latent / step) * step
    preds = (latent / 5 + STSB["noise"] * torch.randn(n, generator=g, device="cuda")).clamp(-1, 1)
    return preds, gold


def pair_count_reference(np, x, y):
    """Concordant, discordant, x-tied and y-tied pairs in float64 numpy (all pairs i < j)."""
    dx = np.sign(x[:, None] - x[None, :])
    dy = np.sign(y[:, None] - y[None, :])
    iu = np.triu_indices(len(x), k=1)
    dx, dy = dx[iu], dy[iu]
    return (int(((dx * dy) > 0).sum()), int(((dx * dy) < 0).sum()), int((dx == 0).sum()), int((dy == 0).sum()))


def ra_stsb(torch, seed: int, smi: str) -> tuple:
    """STS-B dev: Pearson, Spearman and Kendall a/b/c on gold scores with many ties; the
    tie-run ranks against scipy's rankdata, the chain's pair counts against numpy's and
    both plain versions', its times at this shape. Returns the launches and the chain's
    largest difference from the plain versions here."""
    import numpy as np
    from scipy.stats import kendalltau, pearsonr, rankdata, spearmanr

    from metrics_tpu_torch.ops.kendall import _plain_merge_pair_counts, _plain_pair_counts, kendall_pairs_cuda
    from metrics_tpu_torch.ops.rank import average_ranks
    from metrics_tpu_torch.regression import KendallRankCorrCoef, PearsonCorrCoef, SpearmanCorrCoef

    preds, gold = stsb_data(torch, seed)
    metrics = {"PearsonCorrCoef": PearsonCorrCoef(), "SpearmanCorrCoef": SpearmanCorrCoef(),
               **{f"KendallRankCorrCoef_{v}": KendallRankCorrCoef(variant=v) for v in "abc"}}
    for i in range(0, STSB["pairs"], STSB["batch"]):
        for metric in metrics.values():
            metric.update(preds[i:i + STSB["batch"]], gold[i:i + STSB["batch"]])
    values, launches = counted_computes(torch, metrics)
    for name, got in launches.items():
        expect_launches(f"STS-B {name}", got, scan=2 if "Spearman" in name else 0,
                        kendall=1 if "Kendall" in name else 0)

    x, y = preds.double().cpu().numpy(), gold.double().cpu().numpy()
    ranks = average_ranks(torch.stack([preds, gold], 1)).cpu().numpy()
    if not (np.array_equal(ranks[:, 0], rankdata(x)) and np.array_equal(ranks[:, 1], rankdata(y))):
        raise AssertionError("STS-B tie-run ranks differ from scipy's rankdata(method='average')")
    con, dis, tx, ty = pair_count_reference(np, x, y)  # float64 differences of float32 values: same signs
    plain, plain_merge = _plain_pair_counts(preds, gold), _plain_merge_pair_counts(preds, gold)
    counts = kendall_pairs_cuda(preds, gold)
    if counts.tolist() != [[con, dis, tx, ty]] or not torch.equal(counts, plain) \
            or not torch.equal(counts, plain_merge):
        raise AssertionError(f"STS-B pair counts: chain {counts.tolist()}, plain {plain.tolist()} and "
                             f"{plain_merge.tolist()}, numpy {[con, dis, tx, ty]}")
    n_pairs = len(x) * (len(x) - 1) / 2
    want = {"PearsonCorrCoef": pearsonr(x, y)[0], "SpearmanCorrCoef": spearmanr(x, y)[0],
            "KendallRankCorrCoef_a": (con - dis) / n_pairs, "KendallRankCorrCoef_b": kendalltau(x, y)[0],
            "KendallRankCorrCoef_c": kendalltau(x, y, variant="c")[0]}
    errs = {name: abs(float(values[name]) - float(w)) for name, w in want.items()}
    for name, err in errs.items():
        if not err <= (QM9_ATOL if name == "PearsonCorrCoef" else TAU_ATOL):
            raise AssertionError(f"STS-B {name}: {float(values[name])} vs float64 {want[name]} (|err| {err})")

    chain = kendall_chain_timing(torch, preds[:, None], gold[:, None])
    total = {k: sum(v[k] for v in launches.values()) for k in ("segment_scan", "kendall_pairs")}
    emit({"phase": "regression_audio", "config": "stsb", "nvidia_smi": smi, "pairs": STSB["pairs"],
          "gold_tie_runs": int(len(np.unique(y))), "values": {k: float(v) for k, v in values.items()},
          "max_abs_err_vs_float64": errs, "ranks_equal_rankdata": True, "pair_counts": [con, dis, tx, ty],
          "pair_counts_equal_numpy_and_both_plain_versions": True, "launches_per_compute": launches,
          "launches": total, "merge_chain": chain})
    return total, chain["max_abs_err"]


def ptxas_report(name: str) -> dict:
    """Registers, spills and shared memory of each kernel of one source, from ``-Xptxas -v``."""
    import re

    from metrics_tpu_torch import _build

    out = os.path.join(str(_build.BUILD_DIR), f"ptxas-{name}.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", out,
                           str(_build.KERNEL_SOURCES[name])], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v of {name} failed:\n{proc.stderr}")
    text = proc.stderr + proc.stdout
    return {"registers": [int(r) for r in re.findall(r"Used (\d+) registers", text)],
            "spill_stores_bytes": [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)],
            "spill_loads_bytes": [int(s) for s in re.findall(r"(\d+) bytes spill loads", text)],
            "smem_bytes": [int(s) for s in re.findall(r"(\d+) bytes smem", text)]}


def ra_kendall_kernel(torch, seed: int, smi: str) -> dict:
    """The merge-count chain alone. At N = 131,072: bit-equal to both plain versions on
    random values, the closed form past 2^31 on a ramp, its times against its bounds. At
    N = 2^22, a continuous column and one rounded to 64 levels: its counts equal the plain
    merge count's (plain PyTorch on the card), and tau-b from them is within 1e-9 of
    scipy's kendalltau (float64, on the host). At N = 2^24: the ramp's closed forms,
    concordant and discordant. Device ms of each size."""
    import numpy as np
    from scipy.stats import kendalltau

    from metrics_tpu_torch.functional.regression.kendall import _kendall_tau
    from metrics_tpu_torch.ops.kendall import _plain_merge_pair_counts, _plain_pair_counts, kendall_pairs_cuda

    n = KENDALL_ALONE["rows"]
    g = torch.Generator(device="cuda").manual_seed(seed + 700)
    x = torch.randn(n, generator=g, device="cuda")[:, None]
    y = x + torch.randn(n, 1, generator=g, device="cuda")
    out = kendall_chain_timing(torch, x, y)
    out["counts"] = kendall_pairs_cuda(x, y).tolist()[0]
    ramp = torch.arange(n, device="cuda", dtype=torch.float32)
    on_ramp = kendall_pairs_cuda(ramp, ramp)
    both = n * (n - 1) // 2  # 8,589,869,056 at N = 131,072: past 2^31
    if on_ramp.tolist() != [[both, 0, 0, 0]]:
        raise AssertionError(f"kendall merge chain on a ramp: {on_ramp.tolist()}")
    out["max_abs_err"] = max(out["max_abs_err"], (on_ramp - torch.tensor([[both, 0, 0, 0]], device="cuda")).abs()
                             .max().item())
    out["closed_form_concordant"] = both
    out["plain_all_pairs_ms"] = event_ms(torch, lambda: _plain_pair_counts(x, y), reps=3, warmup=1)
    out["ptxas"] = ptxas_report("kendall_merge")
    emit({"phase": "regression_audio", "config": "kendall_kernel", "nvidia_smi": smi, **out})

    at_scale = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 701)
    big = KENDALL_ALONE["rows_at_scale"]
    u = torch.randn(big, 1, generator=g, device="cuda")
    v = u + torch.randn(big, 1, generator=g, device="cuda")
    levels = ((u * 8).round().clamp(-32, 31), (v * 5.5).round().clamp(-32, 31))  # 64 levels each
    for kind, (a, b) in (("continuous", (u, v)), ("64_levels", levels)):
        counts = kendall_pairs_cuda(a, b)
        plain_merge = _plain_merge_pair_counts(a, b)  # every count exact, through the same merge depth
        if not torch.equal(counts, plain_merge):
            raise AssertionError(f"kendall merge chain at N = {big} ({kind}): {counts.tolist()} != plain merge "
                                 f"count {plain_merge.tolist()}")
        tau = float(_kendall_tau(counts, a, b, "b")[0])
        want = float(kendalltau(a[:, 0].double().cpu().numpy(), b[:, 0].double().cpu().numpy())[0])
        if not abs(tau - want) <= KENDALL_SCALE_ATOL:
            raise AssertionError(f"kendall tau-b at N = {big} ({kind}): {tau} vs scipy {want}")
        at_scale[f"{big}_{kind}"] = {"levels": int(torch.unique(a).numel()), "counts": counts.tolist()[0],
                                     "counts_equal_plain_merge_count": True,
                                     "tau_b": tau, "scipy_tau_b": want, "abs_err": abs(tau - want),
                                     "device": call_device_ms(torch, lambda: kendall_pairs_cuda(a, b), "kendall",
                                                              reps=5)}
    del u, v, levels, a, b
    huge = KENDALL_ALONE["rows_closed_form"]
    ramp = torch.arange(huge, device="cuda", dtype=torch.float32)
    both = huge * (huge - 1) // 2
    for kind, sign, want in (("ramp_ramp", 1, [[both, 0, 0, 0]]), ("ramp_minus_ramp", -1, [[0, both, 0, 0]])):
        got = kendall_pairs_cuda(ramp, sign * ramp).tolist()
        if got != want:
            raise AssertionError(f"kendall merge chain at N = {huge} ({kind}): {got}, expected {want}")
        at_scale[f"{huge}_{kind}"] = {"counts": got[0], "device": call_device_ms(
            torch, lambda s=sign: kendall_pairs_cuda(ramp, s * ramp), "kendall", reps=3)}
    emit({"phase": "regression_audio", "config": "kendall_at_scale", "nvidia_smi": smi,
          "tau_b_atol": KENDALL_SCALE_ATOL, **at_scale})
    out["at_scale"] = at_scale
    return out


def libri2mix_data(torch, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 800)
    m, s, t = LIBRI2MIX["mixtures"], LIBRI2MIX["speakers"], LIBRI2MIX["samples"]
    # speech-like sources: noise through a slowly varying envelope
    env = torch.rand(m, s, t // 400 + 1, generator=g, device="cuda").repeat_interleave(400, dim=-1)[..., :t]
    target = env * torch.randn(m, s, t, generator=g, device="cuda")
    perm = torch.stack([torch.randperm(s, generator=g, device="cuda") for _ in range(m)])
    estimates = torch.take_along_dim(target, perm[:, :, None], dim=1)
    estimates = estimates + LIBRI2MIX["noise"] * env * torch.randn(m, s, t, generator=g, device="cuda")
    return estimates, target, perm


def sdr_reference(np, preds, target, filter_length: int):
    """SDR in dB of each (source, estimate) row in float64 numpy: FFT correlations and
    scipy's Levinson solve of the Toeplitz system."""
    from scipy.linalg import solve_toeplitz

    out = []
    for p, t in zip(preds, target):
        t = t / max(np.linalg.norm(t), 1e-6)
        p = p / max(np.linalg.norm(p), 1e-6)
        n_fft = 1 << int(np.ceil(np.log2(len(p) + len(t) - 1)))
        t_fft = np.fft.rfft(t, n=n_fft)
        r_0 = np.fft.irfft(np.abs(t_fft) ** 2, n=n_fft)[:filter_length]
        b = np.fft.irfft(np.conj(t_fft) * np.fft.rfft(p, n=n_fft), n=n_fft)[:filter_length]
        coh = b @ solve_toeplitz(r_0, b)
        out.append(10 * np.log10(coh / (1 - coh)))
    return np.asarray(out)


def ra_libri2mix(torch, seed: int, smi: str) -> dict:
    """Libri2Mix test (8 kHz, min, 4 s): PIT on SI-SDR, SI-SNR, SNR and SDR on the aligned
    estimates, SDR against a float64 host reference, STOI on the host, PESQ's gate."""
    import numpy as np

    from metrics_tpu_torch.audio import (
        PerceptualEvaluationSpeechQuality,
        PermutationInvariantTraining,
        ScaleInvariantSignalNoiseRatio,
        ShortTimeObjectiveIntelligibility,
        SignalDistortionRatio,
        SignalNoiseRatio,
    )
    from metrics_tpu_torch.functional.audio import (
        permutation_invariant_training,
        pit_permutate,
        scale_invariant_signal_distortion_ratio,
        short_time_objective_intelligibility,
        signal_noise_ratio,
    )

    estimates, target, perm = libri2mix_data(torch, seed)
    m, b = LIBRI2MIX["mixtures"], LIBRI2MIX["batch"]
    makers = {"PermutationInvariantTraining": lambda: PermutationInvariantTraining(
                  scale_invariant_signal_distortion_ratio, "max"),
              "ScaleInvariantSignalNoiseRatio": ScaleInvariantSignalNoiseRatio, "SignalNoiseRatio": SignalNoiseRatio}
    metrics = {name: make() for name, make in makers.items()}
    sdr = SignalDistortionRatio(filter_length=LIBRI2MIX["sdr_filter"])
    aligned_all, sdr_mixtures = [], 0
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for i in range(0, m, b):
        est, tgt = estimates[i:i + b], target[i:i + b]
        metrics["PermutationInvariantTraining"].update(est, tgt)
        _, best = permutation_invariant_training(est, tgt, scale_invariant_signal_distortion_ratio, "max")
        aligned = pit_permutate(est, best)
        aligned_all.append(aligned)
        metrics["ScaleInvariantSignalNoiseRatio"].update(aligned, tgt)
        metrics["SignalNoiseRatio"].update(aligned, tgt)
    torch.cuda.synchronize()
    t_sdr = time.perf_counter()
    for i in range(0, m, b):
        if time.perf_counter() - t_sdr > LIBRI2MIX["sdr_seconds"]:
            break  # a listed subset: the mixtures before the limit
        sdr.update(aligned_all[i // b], target[i:i + b])
        sdr_mixtures = min(m, i + b)
    values = {name: float(metric.compute()) for name, metric in metrics.items()}
    values["SignalDistortionRatio"] = float(sdr.compute())
    torch.cuda.synchronize()
    seconds = {"pit_snr": t_sdr - t0, "sdr": time.perf_counter() - t_sdr}
    launches = all_launches()
    if any(launches.values()):
        raise AssertionError(f"Libri2Mix evaluation launched {launches}; no hand kernel is on its path")
    aligned = torch.cat(aligned_all)
    del aligned_all

    # checks: the permutation found is the one drawn; SNRs against float64; SDR against the host
    inverse = torch.argsort(perm, dim=1)
    _, best = permutation_invariant_training(estimates[:b], target[:b], scale_invariant_signal_distortion_ratio)
    if not torch.equal(torch.take_along_dim(perm[:b], best, dim=1),
                       torch.arange(LIBRI2MIX["speakers"], device="cuda").expand(b, -1)):
        raise AssertionError("PIT did not undo the drawn speaker permutation")
    if not torch.equal(aligned, torch.take_along_dim(estimates, inverse[:, :, None], dim=1)):
        raise AssertionError("the PIT-aligned estimates are not the drawn permutation undone")
    p64, t64 = aligned.double(), target.double()
    want = {"SignalNoiseRatio": float(signal_noise_ratio(p64, t64).mean()),
            "ScaleInvariantSignalNoiseRatio": float(scale_invariant_signal_distortion_ratio(p64, t64, True).mean()),
            "PermutationInvariantTraining": float(scale_invariant_signal_distortion_ratio(p64, t64).mean())}
    errs = {name: abs(values[name] - w) for name, w in want.items()}
    for name, err in errs.items():
        if not err <= SNR_ATOL_DB:
            raise AssertionError(f"Libri2Mix {name}: {values[name]} vs float64 {want[name]} dB (|err| {err})")
    k = LIBRI2MIX["sdr_reference_sources"]
    rows_p = aligned.reshape(-1, aligned.shape[-1])[:k]
    rows_t = target.reshape(-1, target.shape[-1])[:k]
    from metrics_tpu_torch.functional.audio import signal_distortion_ratio

    card_sdr = signal_distortion_ratio(rows_p.double(), rows_t.double(), filter_length=LIBRI2MIX["sdr_filter"])
    host_sdr = sdr_reference(np, rows_p.double().cpu().numpy(), rows_t.double().cpu().numpy(), LIBRI2MIX["sdr_filter"])
    sdr_err = float(np.max(np.abs(card_sdr.cpu().numpy() - host_sdr)))
    if not sdr_err <= SDR_ATOL_DB:
        raise AssertionError(f"Libri2Mix SDR on the card vs numpy/scipy float64: max |err| {sdr_err} dB")

    # STOI on the host, from card and from CPU tensors; the class on the first tenth
    s = LIBRI2MIX["stoi_mixtures"]
    t1 = time.perf_counter()
    card_stoi = short_time_objective_intelligibility(aligned[:s], target[:s], LIBRI2MIX["fs"])
    stoi_s = time.perf_counter() - t1
    cpu_stoi = short_time_objective_intelligibility(aligned[:s].cpu(), target[:s].cpu(), LIBRI2MIX["fs"])
    if card_stoi.device.type != "cuda" or not torch.equal(card_stoi.cpu(), cpu_stoi):
        raise AssertionError("STOI of card tensors differs from STOI of CPU tensors")
    stoi = ShortTimeObjectiveIntelligibility(LIBRI2MIX["fs"])
    stoi.update(aligned[:s // 10], target[:s // 10])
    stoi_value = float(stoi.compute())
    if abs(stoi_value - float(card_stoi[:s // 10].double().mean())) > 1e-6:
        raise AssertionError(f"STOI class {stoi_value} vs the mean of its mixtures' values")
    try:
        PerceptualEvaluationSpeechQuality(LIBRI2MIX["fs"], "nb")
    except ModuleNotFoundError as err:
        pesq_error = str(err)
    else:
        raise AssertionError("PESQ built without the `pesq` package")

    batch = (estimates[:b], target[:b])
    aligned_batch = (aligned[:b], target[:b])
    update_ms = {"PermutationInvariantTraining": event_ms(torch, lambda mm=makers["PermutationInvariantTraining"]():
                                                          mm.update(*batch), reps=10)}
    for name in ("ScaleInvariantSignalNoiseRatio", "SignalNoiseRatio"):
        update_ms[name] = event_ms(torch, lambda mm=makers[name](): mm.update(*aligned_batch), reps=10)
    fresh_sdr = SignalDistortionRatio(filter_length=LIBRI2MIX["sdr_filter"])
    update_ms["SignalDistortionRatio"] = event_ms(torch, lambda: fresh_sdr.update(*aligned_batch), reps=5, warmup=1)
    sdr_profile = profile_groups(torch, lambda: fresh_sdr.update(*aligned_batch))
    emit({"phase": "regression_audio", "config": "libri2mix", "nvidia_smi": smi, "mixtures": m,
          "samples": LIBRI2MIX["samples"], "sdr_mixtures": sdr_mixtures, "values": values, "float64": want,
          "max_abs_err_db": errs, "sdr_max_abs_err_db_vs_host": sdr_err, "stoi_mean": float(card_stoi.mean()),
          "stoi_class_first_tenth": stoi_value, "stoi_mixtures": s, "stoi_seconds": stoi_s, "stoi_card_equals_cpu": True, "pesq_error": pesq_error,
          "update_ms_batch_16": update_ms, "sdr_update_profile": sdr_profile, "seconds": seconds,
          "launches": launches})
    return launches


def phase_regression_audio(torch, seed: int, smi: str):
    """Regression and audio at published shapes: NYU Depth v2, QM9, STS-B, Libri2Mix, and
    Kendall's merge-count chain alone. Returns the main path's scan and Kendall launches
    and Kendall's line of the kernels JSON."""
    t0 = time.perf_counter()
    launches = {"segment_scan": 0, "kendall_pairs": 0}
    nyu = ra_nyu(torch, seed, smi)
    torch.cuda.empty_cache()
    (qm9, qm9_err), (stsb, stsb_err) = ra_qm9(torch, seed, smi), ra_stsb(torch, seed, smi)
    for counted in (qm9, stsb, nyu):
        for key in launches:
            launches[key] += counted[key]
    libri = ra_libri2mix(torch, seed, smi)
    torch.cuda.empty_cache()
    for key in launches:
        launches[key] += libri[key]
    alone = ra_kendall_kernel(torch, seed, smi)
    torch.cuda.empty_cache()
    emit({"phase": "regression_audio", "config": "all", "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches, {
        "name": "kendall_pairs",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/kendall_merge.cu",
        "replaces": "metrics_tpu/functional/regression/kendall.py:17 (_kendall_stats_1d; XLA, no Pallas kernel)",
        "launches": launches["kendall_pairs"],
        "max_abs_err": max(qm9_err, stsb_err, alone["max_abs_err"]),
        "ms": alone["kernel_ms"],
        "plain_ms": alone["plain_merge_ms"],
        "bound_ms": alone["bound_ms"],
        "bound_by": alone["bound_by"],
        "library_ms": None,
    }


# UCI Adult (census income, train + test): 48,842 rows; its 8 categorical columns with "?"
# counted as a category: workclass, education, marital-status, occupation, relationship,
# race, sex, native-country. Skewed marginals, education -> occupation and relationship
# -> sex dependent, about 1% NaN where Adult has its "?" (workclass, occupation,
# native-country); the classes stream (education, occupation) in updates of 4,096
ADULT = {"rows": 48_842, "cardinalities": (9, 16, 7, 15, 6, 5, 2, 42), "skew": 1.2,
         "dependent": ((1, 3, 0.6), (4, 6, 0.85)), "nan_columns": (0, 3, 7), "nan_rate": 0.01,
         "class_pair": (1, 3), "batch": 4_096}
NOMINAL_FORMS = ("cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u")
NOMINAL_CLASSES = {"cramers_v": "CramersV", "tschuprows_t": "TschuprowsT",
                   "pearsons_contingency_coefficient": "PearsonsContingencyCoefficient", "theils_u": "TheilsU"}
NOMINAL_ATOL = 1e-6  # the nominal values (float64 on the card, float32 out) against float64 numpy
# BootStrapper over ImageNet-1k val macro accuracy; ClasswiseWrapper and MinMaxMetric beside it
IMAGENET_BOOT = {"batch": 256, "num_bootstraps": 100, "quantile": (0.025, 0.975), "checked_updates": 3,
                 "minmax_computes": 10, "true_class_shift": 7.5}
DLRM_BOOT = {"updates": 20, "batch": 65_536, "num_bootstraps": 20}  # DLRM-style rows, BinaryAUROC copies
AUROC_ATOL = 1e-5  # each copy's AUROC against a float64 Mann-Whitney statistic on its rows
QM9_NAN_RATE = 0.01  # NaN per target in preds and in target, for MultioutputWrapper(remove_nans)
TRACKER_STEPS = 3


def adult_data(torch, seed: int, device="cuda"):
    """The (48,842, 8) float32 matrix of Adult's categorical columns, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed + 1200)
    n = ADULT["rows"]
    cols = []
    for c in ADULT["cardinalities"]:
        weights = torch.arange(1, c + 1, device=device, dtype=torch.float64) ** -ADULT["skew"]
        weights = weights[torch.randperm(c, generator=g, device=device)]
        cols.append(torch.multinomial(weights, n, replacement=True, generator=g))
    for src, dst, share in ADULT["dependent"]:
        mapping = torch.randint(0, ADULT["cardinalities"][dst], (ADULT["cardinalities"][src],), generator=g,
                                device=device)
        follow = torch.rand(n, generator=g, device=device) < share
        cols[dst] = torch.where(follow, mapping[cols[src]], cols[dst])
    m = torch.stack(cols, 1).to(torch.float32)
    for c in ADULT["nan_columns"]:
        m[:, c] = m[:, c].masked_fill(torch.rand(n, generator=g, device=device) < ADULT["nan_rate"], float("nan"))
    return m


def nominal_value(np, cm, name: str) -> float:
    """One table's value in float64 numpy by the JAX package's formulas (default bias
    correction); ``cm`` has no empty row or column."""
    cm = cm.astype(np.float64)
    n = cm.sum()
    if name == "theils_u":
        p_xy = cm / n
        p_y = np.broadcast_to(cm.sum(1, keepdims=True) / n, cm.shape)
        nz = cm > 0
        s_xy = float(np.sum(p_xy[nz] * np.log(p_y[nz] / p_xy[nz])))
        p_x = cm.sum(0) / n
        s_x = float(-np.sum(p_x * np.log(p_x)))
        return 0.0 if s_x == 0 else (s_x - s_xy) / s_x
    r, k = cm.shape
    expected = np.outer(cm.sum(1), cm.sum(0)) / n
    corrected = name != "pearsons_contingency_coefficient"
    if (r - 1) * (k - 1) == 0:
        chi2 = 0.0
    else:
        if (r - 1) * (k - 1) == 1 and corrected:
            diff = expected - cm
            cm = cm + np.sign(diff) * np.minimum(0.5, np.abs(diff))
        chi2 = float(np.sum((cm - expected) ** 2 / expected))
    phi2 = chi2 / n
    if not corrected:
        return float(np.clip(np.sqrt(phi2 / (1 + phi2)), 0.0, 1.0))
    phi2c = max(0.0, phi2 - (r - 1) * (k - 1) / (n - 1))
    rc, kc = r - (r - 1) ** 2 / (n - 1), k - (k - 1) ** 2 / (n - 1)
    if min(rc, kc) == 1:
        return float("nan")
    denom = min(rc - 1, kc - 1) if name == "cramers_v" else np.sqrt((rc - 1) * (kc - 1))
    return float(np.clip(np.sqrt(phi2c / denom), 0.0, 1.0))


def nominal_reference(np, m, nan_strategy: str) -> tuple:
    """Each pair's table as the JAX package builds it (its rows' joint labels densified,
    empty rows and columns dropped), in numpy on the host, and the four forms' (V, V)
    float64 values from them."""
    import itertools

    v = m.shape[1]
    values = {name: np.ones((v, v)) for name in NOMINAL_FORMS}
    tables = {}
    for i, j in itertools.combinations(range(v), 2):
        x, y = m[:, i], m[:, j]
        if nan_strategy == "drop":
            keep = ~(np.isnan(x) | np.isnan(y))
            x, y = x[keep], y[keep]
        else:
            x, y = np.nan_to_num(x, nan=0.0), np.nan_to_num(y, nan=0.0)
        _, inv = np.unique(np.concatenate([x, y]), return_inverse=True)
        c = int(inv.max()) + 1
        cm = np.bincount(inv[len(x):] * c + inv[:len(x)], minlength=c * c).reshape(c, c)
        cm = cm[cm.sum(1) != 0]
        cm = cm[:, cm.sum(0) != 0]
        tables[(i, j)] = cm
        for name in NOMINAL_FORMS:
            values[name][i, j] = nominal_value(np, cm, name)
            values[name][j, i] = nominal_value(np, cm.T, name) if name == "theils_u" else values[name][i, j]
    return tables, values


def dropped_table(table):
    """A padded int64 table without its empty rows and columns, as numpy."""
    t = table.cpu().numpy()
    t = t[t.sum(1) != 0]
    return t[:, t.sum(0) != 0]


def wn_adult(torch, seed: int, smi: str) -> int:
    """UCI Adult through the four ``_matrix`` forms (one histogram launch a call, under
    both NaN strategies) and the four classes on (education, occupation). Returns the
    histogram launches."""
    import itertools

    import numpy as np

    import metrics_tpu_torch.functional.nominal as nominal
    import metrics_tpu_torch.nominal as nominal_classes
    from metrics_tpu_torch.functional.nominal.utils import _densify_columns, _pair_tables
    from metrics_tpu_torch.ops import confmat as ops_confmat
    from metrics_tpu_torch.ops.histogram import _plain_bincount, histogram_cuda

    m = adult_data(torch, seed)
    host = m.double().cpu().numpy()
    cards = ADULT["cardinalities"]
    pairs = list(itertools.combinations(range(len(cards)), 2))
    launches, errs, values, tables = 0, {}, {}, {}
    for strategy in ("replace", "drop"):
        want_tables, want_values = nominal_reference(np, host, strategy)
        for name in NOMINAL_FORMS:
            fn = getattr(nominal, f"{name}_matrix")
            got, counted, _ = run_counted(torch, lambda: fn(m, nan_strategy=strategy))
            expect_launches(f"Adult {name}_matrix {strategy}", counted, histogram=1)
            launches += 1
            if got.dtype != torch.float32 or got.shape != (len(cards), len(cards)) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"Adult {name}_matrix {strategy}: {got}")
            errs[f"{name}/{strategy}"] = float(np.max(np.abs(got.double().cpu().numpy() - want_values[name])))
            if not errs[f"{name}/{strategy}"] <= NOMINAL_ATOL:
                raise AssertionError(f"Adult {name}_matrix {strategy}: off float64 by {errs[f'{name}/{strategy}']}")
            values[f"{name}/{strategy}"] = got
        # the counts: the one launch's tables against 28 plain per-pair counts on the card,
        # a CPU run of the port and the JAX package's per-pair tables (numpy, above)
        ids, valid, got_cards = _densify_columns(m, strategy, 0.0)
        if tuple(got_cards) != cards:
            raise AssertionError(f"Adult {strategy}: cardinalities {got_cards}, drawn {cards}")
        table, _, _ = _pair_tables(m, strategy, 0.0, None)
        cpu_table, _, _ = _pair_tables(m.cpu(), strategy, 0.0, None)
        if not torch.equal(table.cpu(), cpu_table):
            raise AssertionError(f"Adult {strategy}: the card's pair tables differ from the CPU run's")
        for p, (i, j) in enumerate(pairs):
            keep = torch.ones_like(ids[:, i], dtype=torch.bool) if valid is None else valid[:, i] & valid[:, j]
            pair_ids = torch.where(keep, ids[:, j] * cards[i] + ids[:, i], -1)
            plain = _plain_bincount(pair_ids, None, cards[i] * cards[j]).long().reshape(cards[j], cards[i])
            if not torch.equal(table[p, :cards[j], :cards[i]], plain) or int(table[p].sum()) != int(plain.sum()):
                raise AssertionError(f"Adult {strategy} pair {(i, j)}: batched counts differ from the plain count")
            if not np.array_equal(dropped_table(table[p]), want_tables[(i, j)]):
                raise AssertionError(f"Adult {strategy} pair {(i, j)}: counts differ from the per-pair table")
        tables[strategy] = table

    # the classes on (education, occupation), streamed in updates of 4,096 rows
    a, b = ADULT["class_pair"]
    c = max(cards[a], cards[b])
    classes = {name: getattr(nominal_classes, cls)(num_classes=c, nan_strategy="drop")
               for name, cls in NOMINAL_CLASSES.items()}
    batches = [(m[s:s + ADULT["batch"], a], m[s:s + ADULT["batch"], b]) for s in range(0, len(m), ADULT["batch"])]

    def stream():
        for preds, target in batches:
            for metric in classes.values():
                metric.update(preds, target)
        return {name: metric.compute() for name, metric in classes.items()}

    class_values, counted, class_seconds = run_counted(torch, stream)
    expect_launches("Adult classes", counted, histogram=len(classes) * len(batches))
    launches += len(classes) * len(batches)
    p = pairs.index((a, b))
    for name, metric in classes.items():
        if not torch.equal(metric.confmat[:cards[b], :cards[a]], tables["drop"][p, :cards[b], :cards[a]]):
            raise AssertionError(f"Adult {name}: the class's table differs from the pair launch's")
        err = abs(float(class_values[name]) - float(values[f"{name}/drop"][a, b]))
        errs[f"{NOMINAL_CLASSES[name]}/stream"] = err
        if not err <= NOMINAL_ATOL:
            raise AssertionError(f"Adult {NOMINAL_CLASSES[name]}: {class_values[name]} vs the matrix's {err}")

    # timings: each form's call; the pair launch alone (recorded from a call) against the
    # plain version, torch.bincount and the bound; the JAX package's launch pattern, one
    # count-mode launch per pair on the same ids
    matrix_ms = {name: event_ms(torch, lambda: getattr(nominal, f"{name}_matrix")(m, nan_strategy="replace"),
                                reps=10, warmup=2) for name in NOMINAL_FORMS}
    matrix_device = call_device_ms(torch, lambda: nominal.cramers_v_matrix(m, nan_strategy="replace"), "histogram",
                                   reps=5)
    recorded, real = [], ops_confmat._bincount
    ops_confmat._bincount = lambda ids_, bins_: (recorded.append((ids_, bins_)), real(ids_, bins_))[1]
    try:
        nominal.cramers_v_matrix(m, nan_strategy="replace")
    finally:
        ops_confmat._bincount = real
    if len(recorded) != 1:
        raise AssertionError(f"Adult: {len(recorded)} pair launches recorded, not 1")
    pair_ids, bins = recorded[0]
    line = histogram_mode_timing(torch, pair_ids, None, bins, None)
    ids, _, _ = _densify_columns(m, "replace", 0.0)
    per_pair = [(torch.where(torch.ones_like(ids[:, i], dtype=torch.bool), ids[:, j] * cards[i] + ids[:, i], -1)
                 .to(torch.int32).contiguous(), cards[i] * cards[j]) for i, j in pairs]
    line["per_pair_launches_ms"] = event_ms(torch, lambda: [histogram_cuda(x, None, k) for x, k in per_pair], reps=10)
    line["per_pair_launches"] = len(per_pair)
    update_ms = {name: event_ms(torch, lambda: getattr(nominal_classes, NOMINAL_CLASSES[name])(
        num_classes=c, nan_strategy="drop").update(*batches[0]), reps=10) for name in NOMINAL_FORMS}
    emit({"phase": "wrappers_nominal", "config": "adult", "nvidia_smi": smi, "rows": len(m), "cardinalities": cards,
          "pairs": len(pairs), "bins": bins, "ids": pair_ids.numel(),
          "cramers_v_replace": values["cramers_v/replace"].tolist(),
          "class_values": {NOMINAL_CLASSES[k]: float(v) for k, v in class_values.items()},
          "max_abs_err_vs_float64": errs, "atol": NOMINAL_ATOL, "histogram_launches_per_matrix_call": 1,
          "counts_bit_equal": {"plain_per_pair": True, "cpu": True, "numpy_per_pair_tables": True},
          "matrix_call_ms": matrix_ms, "cramers_v_matrix_call_device": matrix_device, "class_update_ms": update_ms, "class_stream_seconds": class_seconds,
          "pair_launch": line, "launches": {"histogram": launches}})
    return launches


def uncached_compute_ms(torch, metric, reps: int = 3) -> float:
    """Event median of ``metric.compute()`` with its own and its children's cached values cleared."""
    def run():
        for module in metric.modules():
            module._computed = None
        metric.compute()
    return event_ms(torch, run, reps=reps, warmup=1)


def imagenet_batches(torch, seed: int, batch: int):
    """ImageNet-1k val logits (a top-1 accuracy near 0.7) and labels, drawn on the card,
    in batches of ``batch`` rows."""
    gi = torch.Generator(device="cuda").manual_seed(seed + 3)
    c, m = IMAGENET["classes"], IMAGENET["samples"]
    logits = 2.0 * torch.randn((m, c), generator=gi, device="cuda")
    labels = torch.randint(0, c, (m,), generator=gi, device="cuda")
    logits[torch.arange(m, device="cuda"), labels] += IMAGENET_BOOT["true_class_shift"]
    return [(logits[s:s + batch], labels[s:s + batch]) for s in range(0, m, batch)]


def wn_imagenet(torch, seed: int, smi: str) -> None:
    """ImageNet-1k val logits through ClasswiseWrapper and MinMaxMetric (the stacked
    BootStrapper over the same logits is ``phase_wrappers_stacked``'s)."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import ClasswiseWrapper, MinMaxMetric

    cfg = IMAGENET_BOOT
    c, m = IMAGENET["classes"], IMAGENET["samples"]
    batches = imagenet_batches(torch, seed, cfg["batch"])
    classwise = ClasswiseWrapper(MulticlassAccuracy(c, average=None))
    minmax = MinMaxMetric(MulticlassAccuracy(c, average="macro"))
    at = {round((i + 1) * len(batches) / cfg["minmax_computes"]) - 1 for i in range(cfg["minmax_computes"])}
    seen = []

    def drive_wrappers():
        for k, batch in enumerate(batches):
            classwise.update(*batch)
            minmax.update(*batch)
            if k in at:
                seen.append({key: v.clone() for key, v in minmax.compute().items()})
        return classwise.compute()

    per_class, counted, wrapper_seconds = run_counted(torch, drive_wrappers)
    expect_launches("ImageNet ClasswiseWrapper and MinMaxMetric", counted)
    apart_none, apart_macro = MulticlassAccuracy(c, average=None), MulticlassAccuracy(c, average="macro")
    raws = []
    for k, batch in enumerate(batches):
        apart_none.update(*batch)
        apart_macro.update(*batch)
        if k in at:
            raws.append(apart_macro.compute().clone())
            apart_macro._computed = None
    want_none = apart_none.compute()
    if list(per_class) != [f"multiclassaccuracy_{i}" for i in range(c)] or not torch.equal(
            torch.stack(list(per_class.values())), want_none):
        raise AssertionError("ImageNet ClasswiseWrapper differs from MulticlassAccuracy(average=None)")
    if len(seen) != cfg["minmax_computes"]:
        raise AssertionError(f"ImageNet MinMaxMetric: {len(seen)} computes")
    for i, (got, raw_i) in enumerate(zip(seen, raws)):
        so_far = torch.stack(raws[:i + 1])
        if not (torch.equal(got["raw"], raw_i) and torch.equal(got["max"], so_far.max())
                and torch.equal(got["min"], so_far.min())):
            raise AssertionError(f"ImageNet MinMaxMetric compute {i}: {got} vs raw {raws[:i + 1]}")
    timing = {"classwise_update_ms": event_ms(torch, lambda: classwise.update(*batches[0]), reps=10),
              "minmax_compute_ms": uncached_compute_ms(torch, minmax)}
    emit({"phase": "wrappers_nominal", "config": "imagenet", "nvidia_smi": smi, "rows": m, "classes": c,
          "updates": len(batches), "minmax": {k: float(v) for k, v in seen[-1].items()}, "timing": timing,
          "seconds": {"classwise_and_minmax": wrapper_seconds}})


def dlrm_style_batches(torch, seed: int, updates: int, batch: int):
    """``updates`` batches of DLRM-style rows (3% positives, bf16 click scores), drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = updates * batch
    target = (torch.rand(n, generator=g, device="cuda") < DLRM["positive_rate"]).long()
    z = torch.randn(n, generator=g, device="cuda") + DLRM["positive_shift"] * target
    scores = torch.sigmoid(z).to(torch.bfloat16).to(torch.float32)
    return [(scores[s:s + batch], target[s:s + batch]) for s in range(0, n, batch)]


def wn_dlrm(torch, seed: int, smi: str) -> int:
    """DLRM-style rows through BootStrapper(BinaryAUROC(), 20): list-state copies, one scan
    launch per copy compute. Returns the scan launches."""
    import numpy as np

    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.wrappers import BootStrapper

    cfg = DLRM_BOOT
    b = cfg["batch"]
    batches = dlrm_style_batches(torch, seed + 1, cfg["updates"], b)
    boot = BootStrapper(BinaryAUROC(), num_bootstraps=cfg["num_bootstraps"], raw=True, seed=seed)
    _, counted, update_seconds = run_counted(torch, lambda: [boot.update(*batch) for batch in batches])
    expect_launches("DLRM BootStrapper updates", counted)
    value, counted, compute_seconds = run_counted(torch, boot.compute)
    expect_launches("DLRM BootStrapper compute", counted, scan=cfg["num_bootstraps"])
    # the draws, replayed: per update, per copy, one Poisson(1) count per row
    rng = np.random.default_rng(seed)
    rows = np.zeros(cfg["num_bootstraps"], dtype=np.int64)
    for _ in batches:
        for k in range(cfg["num_bootstraps"]):
            rows[k] += int(rng.poisson(1, size=b).sum())
    errs = []
    for k, copy in enumerate(boot.metrics):
        preds, labels = torch.cat(copy.preds), torch.cat(copy.target)
        if preds.numel() != rows[k]:
            raise AssertionError(f"DLRM BootStrapper copy {k}: {preds.numel()} rows, the draws give {rows[k]}")
        errs.append(abs(float(value["raw"][k]) - mann_whitney_auc(torch, preds, labels)))
    if not max(errs) <= AUROC_ATOL:
        raise AssertionError(f"DLRM BootStrapper: a copy's AUROC off float64 by {max(errs)}")
    timed = BootStrapper(BinaryAUROC(), num_bootstraps=cfg["num_bootstraps"], seed=seed)
    timing = {"update_ms": event_ms(torch, lambda: timed.update(*batches[0]), reps=5, warmup=1),
              "update_device": call_device_ms(torch, lambda: timed.update(*batches[0]), "segment_scan", reps=2),
              "compute_ms": uncached_compute_ms(torch, boot)}
    emit({"phase": "wrappers_nominal", "config": "dlrm_bootstrap", "nvidia_smi": smi, "rows": cfg["updates"] * b,
          "updates": len(batches), "num_bootstraps": cfg["num_bootstraps"],
          "values": {k: v.tolist() for k, v in value.items()}, "max_abs_err_vs_float64": max(errs),
          "atol": AUROC_ATOL, "scan_launches_per_compute": cfg["num_bootstraps"], "timing": timing,
          "seconds": {"updates": update_seconds, "compute": compute_seconds}})
    return cfg["num_bootstraps"]


def wn_qm9(torch, seed: int, smi: str) -> None:
    """QM9 with 1% NaN per target through MultioutputWrapper(PearsonCorrCoef(), 12)."""
    import numpy as np

    from metrics_tpu_torch.regression import PearsonCorrCoef
    from metrics_tpu_torch.wrappers import MultioutputWrapper

    preds, target = qm9_data(torch, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1300)
    preds = preds.masked_fill(torch.rand(preds.shape, generator=g, device="cuda") < QM9_NAN_RATE, float("nan"))
    target = target.masked_fill(torch.rand(target.shape, generator=g, device="cuda") < QM9_NAN_RATE, float("nan"))
    n, c, b = preds.shape[0], preds.shape[1], QM9["batch"]
    wrapper = MultioutputWrapper(PearsonCorrCoef(), c)

    def drive():
        for s in range(0, n, b):
            wrapper.update(preds[s:s + b], target[s:s + b])
        return wrapper.compute()

    value, counted, seconds = run_counted(torch, drive)
    expect_launches("QM9 MultioutputWrapper", counted)
    apart = [PearsonCorrCoef() for _ in range(c)]
    for s in range(0, n, b):
        for i, metric in enumerate(apart):
            p, t = preds[s:s + b, i], target[s:s + b, i]
            keep = ~(torch.isnan(p) | torch.isnan(t))
            metric.update(p[keep], t[keep])
    want = torch.stack([metric.compute() for metric in apart])
    if not torch.equal(value, want):
        raise AssertionError(f"QM9 MultioutputWrapper {value} vs per-column PearsonCorrCoef {want}")
    p64, t64 = preds.double().cpu().numpy(), target.double().cpu().numpy()
    ref = []
    for i in range(c):
        keep = ~(np.isnan(p64[:, i]) | np.isnan(t64[:, i]))
        ref.append(np.corrcoef(p64[keep, i], t64[keep, i])[0, 1])
    err = float(np.max(np.abs(value.double().cpu().numpy() - np.asarray(ref))))
    if not err <= QM9_ATOL:
        raise AssertionError(f"QM9 MultioutputWrapper off float64 by {err}")
    emit({"phase": "wrappers_nominal", "config": "qm9_multioutput", "nvidia_smi": smi, "molecules": n, "targets": c,
          "nan_rate": QM9_NAN_RATE, "values": value.tolist(), "bit_equal_to_per_column": True,
          "max_abs_err_vs_float64": err, "atol": QM9_ATOL, "seconds": seconds,
          "update_ms": event_ms(torch, lambda: wrapper.update(preds[:b], target[:b]), reps=10)})


def wn_tracker(torch, seed: int, smi: str) -> int:
    """MetricTracker over the Cityscapes collection, one batch a step. Returns the histogram launches."""
    import warnings

    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.wrappers import MetricTracker

    g = torch.Generator(device="cuda").manual_seed(seed + 1400)
    batches = [cityscapes_batch(torch, g) for _ in range(TRACKER_STEPS)]
    tracker = MetricTracker(MetricCollection(collection_metrics("cuda")), maximize=True)

    def drive():
        for batch in batches:
            tracker.increment()
            tracker.update(*batch)
        return tracker.compute_all()

    values, counted, seconds = run_counted(torch, drive)
    expect_launches("MetricTracker", counted, histogram=len(COLLECTION_GROUPS) * len(batches))
    for k, batch in enumerate(batches):
        apart = MetricCollection(collection_metrics("cuda"))
        apart.update(*batch)
        for name, value in apart.compute().items():
            if not torch.equal(values[name][k], value):
                raise AssertionError(f"MetricTracker step {k} {name}: {values[name][k]} vs {value}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the confusion matrix has no best value: None, with a warning
        best, step = tracker.best_metric(return_step=True)
    for name, value in values.items():
        if value.dim() == 1:
            if best[name] != float(value.max()) or step[name] != int(value.argmax()):
                raise AssertionError(f"MetricTracker best {name}: {best[name]} at {step[name]} vs {value}")
    emit({"phase": "wrappers_nominal", "config": "tracker", "nvidia_smi": smi, "steps": len(batches),
          "best": best, "best_step": step, "seconds": seconds, "histogram_launches": counted["histogram"]})
    return counted["histogram"]


def phase_wrappers_nominal(torch, seed: int, smi: str):
    """Nominal association on UCI Adult and the five wrappers (ImageNet, DLRM-style rows,
    QM9, the Cityscapes collection). Returns the main path's histogram and scan launches."""
    t0 = time.perf_counter()
    launches = {"histogram": wn_adult(torch, seed, smi)}
    torch.cuda.empty_cache()
    wn_imagenet(torch, seed, smi)
    launches["segment_scan"] = wn_dlrm(torch, seed, smi)
    torch.cuda.empty_cache()
    wn_qm9(torch, seed, smi)
    launches["histogram"] += wn_tracker(torch, seed, smi)
    torch.cuda.empty_cache()
    emit({"phase": "wrappers_nominal", "config": "all", "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# ----------------------------------------------------------------- engines

# the MLPerf DLRM-v2 global batch as the fused step's rows; CIFAR-10's 10 classes for the
# fleet, with the JAX package's canonical 16 streams (core/fleet.py:547)
ENGINES = {"rows": 65_536, "steps": 200, "timed_steps": 50, "fleet_size": 16, "classes": 10, "fleet_rows": 10_000,
           "fleet_updates": 20}
# (rows, ids a row, bins a row) of the batched mode: the fleet's routed update, 16 long rows
# of 4 bins, and 100 bootstrap copies of a 1,000-class ImageNet confusion matrix
BATCHED_SHAPES = ((10_000, 1, 100), (16, 65_536, 4), (100, 256, 1_000_000))
FLEET_REL = 1e-6  # MeanSquaredError's fleet against independent metrics: the fold reorders float sums


def batched_inputs(torch, g, rows: int, k: int, bins: int):
    ids = torch.randint(-2, bins + 2, (rows, k), generator=g, device="cuda", dtype=torch.int32)
    ids[0] = -1  # an empty row
    mask = torch.rand((rows, k), generator=g, device="cuda") < 0.7
    # quarter steps: every order of the float atomics gives the same sums, so f32 is bit-equal too
    quarters = torch.randint(-8, 8, (rows, k), generator=g, device="cuda").float() / 4
    return ids, mask, quarters


def check_batched(torch, g) -> list:
    """The batched mode bit-equal to its plain version row by row (count, mask and
    quarter-step f32 weights; random f32 weights within 1e-5 of each bin's |w| sum),
    then timed at each shape beside its bound, its plain version and ``torch.bincount``
    over the row-offset ids. Returns one record per shape."""
    from metrics_tpu_torch.ops.histogram import _plain_batched_bincount, histogram_batched_cuda

    records = []
    for rows, k, bins in BATCHED_SHAPES:
        ids, mask, quarters = batched_inputs(torch, g, rows, k, bins)
        for name, weights in (("count", None), ("mask", mask), ("f32", quarters)):
            got, want = histogram_batched_cuda(ids, weights, bins), _plain_batched_bincount(ids, weights, bins)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"batched {name} kernel != plain at ({rows}, {k}, {bins})")
        noisy = torch.randn((rows, k), generator=g, device="cuda")
        err = (histogram_batched_cuda(ids, noisy, bins).double() - _plain_batched_bincount(ids, noisy.double(), bins)).abs()
        if not bool(torch.all(err <= 1e-5 * _plain_batched_bincount(ids, noisy.abs().double(), bins))):
            raise AssertionError(f"batched f32 kernel off at ({rows}, {k}, {bins})")
        total = rows * bins
        offsets = torch.arange(rows, device="cuda").unsqueeze(1) * bins
        flat = torch.where((ids >= 0) & (ids < bins), ids.long() + offsets, total).reshape(-1)
        lib = torch.bincount(flat, minlength=total + 1)[:total].reshape(rows, bins)
        if not torch.equal(lib.int(), histogram_batched_cuda(ids, None, bins)):
            raise AssertionError(f"torch.bincount disagrees at ({rows}, {k}, {bins})")
        # device time of one wrapper call: the kernel and the memset that zeroes its
        # (B, bins) output, whose bytes the bound counts
        device = call_device_ms(torch, lambda: histogram_batched_cuda(ids, None, bins), "histogram_batched")
        records.append({
            "shape": [rows, k, bins],
            "max_abs_err": 0,
            "event_ms": event_ms(torch, lambda: histogram_batched_cuda(ids, None, bins)),
            "device_ms": None if device is None else device["device_ms"],
            "kernel_ms": None if device is None else device["hand_kernels_ms"],
            "memset_ms": None if device is None else device["memset_ms"],
            "plain_ms": event_ms(torch, lambda: _plain_batched_bincount(ids, None, bins)),
            "library_ms": event_ms(torch, lambda: torch.bincount(flat, minlength=total + 1)),
            "bound_ms": (ids.numel() * 4 + total * 4) / HBM_BYTES_PER_S * 1e3,
        })
    return records


def step_profile(torch, fn, reps: int = 10) -> dict:
    """Kernel (and memset and copy) launches and device ms per ``fn()`` call from a
    profiler trace, and the histogram kernels' launches among them. The wrappers'
    counts over the same calls (the trace's window and its warmup step, plus the
    call before them) must equal the launches that the trace shows, replays included."""
    torch.cuda.synchronize()
    zero_launches()
    launches = device_launches(profile_window(torch, fn, reps))
    counted = all_launches()
    out = {"launches_per_step": sum(n for n, _ in launches.values()) / reps,
           "device_ms_per_step": sum(us for _, us in launches.values()) / reps / 1e3,
           "histogram_per_step": sum(n for key, (n, _) in launches.items() if "histogram_kernel" in key) / reps,
           "batched_per_step": sum(n for key, (n, _) in launches.items() if "histogram_batched_kernel" in key) / reps}
    for name, per_step in (("histogram", out["histogram_per_step"]), ("histogram_batched", out["batched_per_step"])):
        if counted[name] != (2 * reps + 1) * per_step:
            raise AssertionError(f"{name}: the wrapper counted {counted[name]} launches over {2 * reps + 1}"
                                 f" calls, the trace shows {per_step} a call")
    return out


def engines_fused(torch, g, smi: str) -> dict:
    """The canonical collection fused and eager over the same 200 steps, bit-identical,
    one replay a step; then step timings and the mixed collection."""
    import warnings

    from metrics_tpu_torch.classification import BinaryAccuracy, BinaryAUROC
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.core.fused import canonical_collection, engine_for
    from metrics_tpu_torch.regression import MeanSquaredError

    n, steps = ENGINES["rows"], ENGINES["steps"]
    preds = torch.rand((steps, n), generator=g, device="cuda")
    target = torch.randint(0, 2, (steps, n), generator=g, device="cuda", dtype=torch.int32)
    fused, eager = canonical_collection(True), canonical_collection(False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, fused_launches, fused_s = run_counted(torch, lambda: [fused.update(preds[i], target[i]) for i in range(steps)])
        _, eager_launches, _ = run_counted(torch, lambda: [eager.update(preds[i], target[i]) for i in range(steps)])
        got, want = fused.compute(), eager.compute()
    demotions = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    stats = dict(engine_for(fused).stats)
    if demotions or stats["launches"] != steps or stats["degrades"] or stats["fallback_groups"]:
        raise AssertionError(f"fused collection: stats {stats}, demotions {demotions}")
    # the eager step's histogram launches, run once by the capture's warm-up and once by each replay
    per_step = eager_launches["histogram"] // steps
    if per_step < 1 or eager_launches["histogram"] != per_step * steps:
        raise AssertionError(f"eager canonical collection: launches {eager_launches}")
    expect_launches("fused canonical collection", fused_launches, histogram=per_step * (steps + 1))
    for name, value in want.items():
        if value.dtype != got[name].dtype or not torch.equal(value, got[name]):
            raise AssertionError(f"fused {name} {got[name]} != eager {value}")
    timed = {"fused": canonical_collection(True), "eager": canonical_collection(False)}
    p, t = preds[0], target[0]
    step = {}
    for kind, coll in timed.items():
        step[kind] = {"event_ms_median": event_ms(torch, lambda: coll.update(p, t), reps=ENGINES["timed_steps"]),
                      **step_profile(torch, lambda: coll.update(p, t))}
    if step["fused"]["histogram_per_step"] != per_step or step["eager"]["histogram_per_step"] != per_step:
        raise AssertionError(f"histogram launches a step (trace): {step}, the eager wrappers' {per_step}")
    # the JAX package's mixed collection: 2 groups fused, 2 eager, bit-identical to eager
    def mixed(fuse):
        return MetricCollection({"acc": BinaryAccuracy(), "auroc_exact": BinaryAUROC(thresholds=None),
                                 "mse_cpu": MeanSquaredError(compute_on_cpu=True),
                                 "auroc_binned": BinaryAUROC(thresholds=11)}, fused=fuse)
    mf, me = mixed(True), mixed(False)
    for i in range(4):
        mf.update(preds[i], target[i])
        me.update(preds[i], target[i])
    got, want = mf.compute(), me.compute()
    if not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("the mixed fused collection differs from eager")
    mixed_stats = dict(engine_for(mf).stats)
    if (mixed_stats["launches"], mixed_stats["fallback_groups"], mixed_stats["degrades"]) != (4, 8, 0):
        raise AssertionError(f"mixed collection stats {mixed_stats}")
    record = {"steps": steps, "rows": n, "stats": stats, "mixed_stats": mixed_stats, "bit_identical": True,
              "host_s_200_fused_steps": fused_s, "launches": fused_launches, "step": step,
              "speedup_event": step["eager"]["event_ms_median"] / step["fused"]["event_ms_median"]}
    emit({"phase": "engines_fused", "card": smi, **record})
    return record


def engines_fleet(torch, g, smi: str) -> dict:
    """The routed fleet at CIFAR-10 width against 16 independent metrics, bit-identical;
    the JAX package's canonical fleets; broadcast and reduce_fleet. A step demoted to
    eager anywhere in it (a fleet's ``degrades``) fails the phase."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core import MaxMetric
    from metrics_tpu_torch.core.fleet import step_stats
    from metrics_tpu_torch.regression import MeanSquaredError

    size, c, rows = ENGINES["fleet_size"], ENGINES["classes"], ENGINES["fleet_rows"]
    updates = [(torch.randint(0, c, (rows,), generator=g, device="cuda"),
                torch.randint(0, c, (rows,), generator=g, device="cuda"),
                torch.randint(0, size - 1, (rows,), generator=g, device="cuda"))  # stream 15 stays empty
               for _ in range(ENGINES["fleet_updates"])]
    fleet = MulticlassAccuracy(num_classes=c, average=None, fleet_size=size)
    _, counted, fleet_s = run_counted(torch, lambda: [fleet.update(p, t, stream_ids=i) for p, t, i in updates])
    # one batched launch a routed update: the capture's warm-up and each of the 20 replays
    expect_launches("fleet routed updates", counted, batched=len(updates) + 1)
    if step_stats(fleet)["launches"] != len(updates) or step_stats(fleet)["degrades"]:
        raise AssertionError(f"fleet steps: {step_stats(fleet)}")
    refs = [MulticlassAccuracy(num_classes=c, average=None) for _ in range(size)]
    for p, t, i in updates:
        for s in range(size - 1):
            refs[s].update(p[i == s], t[i == s])
    out = fleet.compute()
    for s in range(size):
        want = refs[s].compute() if s < size - 1 else torch.zeros(c, device="cuda")
        if not torch.equal(out[s], want) or not torch.equal(fleet.compute(stream=s), want):
            raise AssertionError(f"fleet stream {s}: {out[s]} != {want}")
    p, t, i = updates[0]
    per_update = {"event_ms_median": event_ms(torch, lambda: fleet.update(p, t, stream_ids=i), reps=20),
                  **step_profile(torch, lambda: fleet.update(p, t, stream_ids=i))}
    if per_update["batched_per_step"] != 1 or per_update["histogram_per_step"] != 0:
        raise AssertionError(f"a routed fleet replay (trace): {per_update}")
    # the JAX package's canonical fleets, each against independent metrics
    canon = {"micro": (MulticlassAccuracy(num_classes=5, average="micro", fleet_size=size),
                       lambda: MulticlassAccuracy(num_classes=5, average="micro")),
             "mse": (MeanSquaredError(fleet_size=size), MeanSquaredError),
             "max": (MaxMetric(fleet_size=size), MaxMetric)}
    x = torch.rand(rows, generator=g, device="cuda")
    y = torch.rand(rows, generator=g, device="cuda")
    lab = torch.randint(0, 5, (rows,), generator=g, device="cuda")
    pred = torch.randint(0, 5, (rows,), generator=g, device="cuda")
    ids = torch.randint(0, size, (rows,), generator=g, device="cuda")
    args = {"micro": (pred, lab), "mse": (x, y), "max": (x,)}
    worst_rel = 0.0
    for name, (metric, make) in canon.items():
        metric.update(*args[name], stream_ids=ids)
        metric.update(*args[name])  # a broadcast update: every stream
        whole = make()
        for _ in range(size + 1):
            whole.update(*args[name])
        value = metric.compute()
        for s in range(size):
            ref = make()
            ref.update(*(a[ids == s] for a in args[name]))
            ref.update(*args[name])
            if name == "mse":
                worst_rel = max(worst_rel, ((value[s] - ref.compute()).abs() / ref.compute().abs()).item())
            elif not torch.equal(value[s], ref.compute()):
                raise AssertionError(f"canonical fleet {name} stream {s}: {value[s]} != {ref.compute()}")
        reduced = metric.reduce_fleet()
        if name == "mse":
            worst_rel = max(worst_rel, ((reduced - whole.compute()).abs() / whole.compute().abs()).item())
        elif not torch.equal(reduced, whole.compute()):
            raise AssertionError(f"reduce_fleet {name}: {reduced} != {whole.compute()}")
    if worst_rel > FLEET_REL:
        raise AssertionError(f"MeanSquaredError fleet off by {worst_rel} relative")
    degraded = {name: step_stats(metric) for name, (metric, _) in canon.items() if step_stats(metric)["degrades"]}
    if degraded or step_stats(fleet)["degrades"]:
        raise AssertionError(f"fleet steps demoted: {degraded or step_stats(fleet)}")
    record = {"fleet_size": size, "classes": c, "rows": rows, "updates": ENGINES["fleet_updates"],
              "bit_identical": True, "host_s_20_updates": fleet_s, "launches": counted,
              "steps": step_stats(fleet), "per_update": per_update, "mse_worst_rel": worst_rel}
    emit({"phase": "engines_fleet", "card": smi, **record})
    return record


def phase_engines(torch, seed: int, smi: str):
    """The batched mode against its plain version, the fused collection and the fleet.
    Returns the batched mode's line of the kernels JSON (its launches: the fleet's 20
    routed updates, one in each replay and one in the capture's warm-up) and the
    histogram kernel's launches on the fused collection's path (its 200 replays and
    the warm-up)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    t0 = time.perf_counter()
    batched = check_batched(torch, g)
    emit({"phase": "engines_batched", "card": smi, "shapes": batched})
    fused = engines_fused(torch, g, smi)
    fleet = engines_fleet(torch, g, smi)
    replays = {"histogram_per_fused_step": fused["step"]["fused"]["histogram_per_step"],
               "batched_per_fleet_update": fleet["per_update"]["batched_per_step"]}
    emit({"phase": "engines", "seconds": time.perf_counter() - t0, "launches_per_replay": replays})
    main = batched[0]  # the fleet's routed update: (10,000, 1, 100)
    return {
        "name": "histogram_batched",
        "route": "cuda",
        "source": "metrics_tpu_torch/csrc/histogram.cu",
        "replaces": "metrics_tpu/ops/histogram.py:87",
        "launches": fleet["launches"]["histogram_batched"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["event_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }, fused["launches"]["histogram"]


# ----------------------------------------------------------------- wrappers_stacked

# DLRM-style rows through a pure-tier BootStrapper of exact AUROC: 16 updates of the MLPerf
# DLRM-v2 batch fill 2^20 rows a copy (Criteo day 23 holds 89,137,319: cut to fit 20 copies)
DLRM_PURE = {"updates": 16, "batch": 65_536, "num_bootstraps": 20, "capacity": 1 << 20, "curve_copies": 4}
PURE_AUROC_RTOL = 1e-6  # a copy's traced AUROC (batched sums) against its own eager compute
# the BootStrapper copies path on the same ImageNet updates, as measured before the stacked path (PERF.md §5)
COPIES_PATH_MEASURED = {"wall_ms_per_update": 93.5, "device_ms_per_update": 10.3, "launches_per_update": 3_701}


def ws_imagenet(torch, seed: int, smi: str) -> dict:
    """BootStrapper(MulticlassAccuracy(1000, "macro"), 100) over ImageNet-1k val in
    updates of 256: one replay a step, one batched histogram launch in it. The first
    updates are held bit for bit against 100 base metrics fed the same indices."""
    import numpy as np

    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core.fleet import step_stats
    from metrics_tpu_torch.wrappers import BootStrapper

    cfg = IMAGENET_BOOT
    c, n_boot = IMAGENET["classes"], cfg["num_bootstraps"]
    batches = imagenet_batches(torch, seed, cfg["batch"])
    names = ("tp", "fp", "tn", "fn")

    def bootstrapper():
        return BootStrapper(MulticlassAccuracy(c, average="macro"), num_bootstraps=n_boot,
                            quantile=list(cfg["quantile"]), raw=True, seed=seed)

    boot, early = bootstrapper(), {}
    if not boot._eager_stacked:
        raise AssertionError("ImageNet BootStrapper did not take the stacked path")

    def drive():
        for k, batch in enumerate(batches):
            boot.update(*batch)
            if k + 1 == cfg["checked_updates"]:
                early.update({name: getattr(boot, f"boot_{name}").clone() for name in names})
        return boot.compute()

    value, counted, seconds = run_counted(torch, drive)
    shapes = len({tuple(b[0].shape) for b in batches})  # a last, shorter batch is a second capture
    expect_launches("ImageNet stacked BootStrapper", counted, batched=len(batches) + shapes)
    stats = step_stats(boot)
    if stats["degrades"] or stats["launches"] != len(batches):
        raise AssertionError(f"ImageNet stacked BootStrapper steps: {stats}")
    # the same indices, replayed: the host seed stream and the draws' generator on the card
    rng = np.random.default_rng(seed)
    bases = [MulticlassAccuracy(c, average="macro") for _ in range(n_boot)]
    for batch in batches[:cfg["checked_updates"]]:
        size = batch[0].shape[0]
        idx = boot._indices(boot._device_draws(int(rng.integers(0, 2**63 - 1)), size), size)
        for base, rows in zip(bases, idx):
            base.update(batch[0][rows], batch[1][rows])
    for name in names:
        if not torch.equal(early[name], torch.stack([getattr(b, name) for b in bases])):
            raise AssertionError(f"ImageNet stacked BootStrapper: {name} after {cfg['checked_updates']} updates"
                                 " differs from 100 base metrics fed the same indices")
    template = boot.metrics[0]
    raw = torch.stack([template.compute_from({name: getattr(boot, f"boot_{name}")[k] for name in names})
                       for k in range(n_boot)])
    raw_err = (value["raw"] - raw).abs().max().item()
    stat_err = max((value["mean"] - raw.mean()).abs().item(), (value["std"] - raw.std()).abs().item())
    if not (raw_err <= 1e-6 and stat_err <= 1e-6 and bool(((raw > 0) & (raw < 1)).all())):
        raise AssertionError(f"ImageNet stacked BootStrapper: raw off its copies' computes by {raw_err},"
                             f" mean/std by {stat_err}")
    timed = bootstrapper()
    timed.update(*batches[0])  # the capture, outside the windows
    timing = {"wall_ms_per_update": event_ms(torch, lambda: timed.update(*batches[0]), reps=20, warmup=2),
              "device_per_update": call_device_ms(torch, lambda: timed.update(*batches[0]), "histogram_batched",
                                                  reps=5),
              "compute_ms": uncached_compute_ms(torch, boot)}
    by_kernel = device_ms(torch, lambda: timed.update(*batches[0]), reps=5)
    timing["device_ms_by_kernel_top"] = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    if timing["device_per_update"] is None:
        raise AssertionError("ImageNet stacked BootStrapper: no profiler window held every launch")
    per_update = timing["device_per_update"]["launches_per_call"]
    if sum(n for k, n in per_update.items() if "histogram_batched" in k) != 1:
        raise AssertionError(f"ImageNet stacked BootStrapper: launches per update {per_update}")
    record = {"rows": IMAGENET["samples"], "classes": c, "updates": len(batches), "num_bootstraps": n_boot,
              "batched_launches": counted["histogram_batched"], "captures": shapes, "steps": stats,
              "first_updates_bit_equal_to_base_metrics": cfg["checked_updates"], "raw_err_vs_copies": raw_err,
              "mean_std_err_vs_copies": stat_err,
              "values": {k: v.tolist() for k, v in value.items() if k != "raw"}, "timing": timing,
              "launches_per_update": sum(per_update.values()), "copies_path_measured": COPIES_PATH_MEASURED,
              "seconds": seconds}
    emit({"phase": "wrappers_stacked", "config": "imagenet", "nvidia_smi": smi, **record})
    return record


def batched_scan_timing(torch, n: int, row: int) -> dict:
    """The scan launch of a vmapped exact curve, alone: two int32 ``min`` lanes of ``n``
    rows, reverse, a segment flag at the end of each ``row`` (the batching rule's flags),
    against its plain version. Bound: lanes read and written once, flags read once.
    Library yardstick: the same function in one call, ``torch.cummin`` along the last
    dim of the two lanes as one ``(2, n / row, row)`` tensor, flipped beforehand (as the
    DLRM row's ``torch.cummin``)."""
    from metrics_tpu_torch.ops.segment import _plain_multi_scan, segment_scan_cuda

    g = torch.Generator(device="cuda").manual_seed(n)
    lanes = [torch.randint(0, 1 << 30, (n,), generator=g, device="cuda", dtype=torch.int32) for _ in range(2)]
    flags = (torch.arange(n, device="cuda") % row) == row - 1
    ops = ("min", "min")
    got = segment_scan_cuda(lanes, flags, ops, True)
    want = _plain_multi_scan(lanes, flags, ops, True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the batched scan launch differs from its plain version")
    flipped = torch.stack(lanes).view(2, n // row, row).flip(-1).contiguous()
    library = torch.cummin(flipped, -1).values.flip(-1).reshape(2, n)
    if not all(torch.equal(a, b) for a, b in zip(got, library)):
        raise AssertionError("torch.cummin of the flipped rows differs from the batched scan")
    del library
    return {"rows": n, "segment_rows": row, "event_ms": event_ms(torch, lambda: segment_scan_cuda(lanes, flags, ops, True)),
            "device_ms": kernel_device_ms(torch, lambda: segment_scan_cuda(lanes, flags, ops, True), "segment_scan"),
            "plain_ms": event_ms(torch, lambda: _plain_multi_scan(lanes, flags, ops, True), reps=3, warmup=1),
            "bound_ms": n * (4 * 2 * 2 + 1) / HBM_BYTES_PER_S * 1e3,
            "library_ms": event_ms(torch, lambda: torch.cummin(flipped, -1))}


def ws_dlrm_pure(torch, seed: int, smi: str) -> dict:
    """BootStrapper(BinaryAUROC(cat_capacity=2^20), 20) through the pure tier: 16 updates
    of 65,536 rows fill each copy's buffer, and ``compute_from`` is one batched sort and
    one scan launch. Then the traced PR curve and ROC of the first copies' buffers."""
    from metrics_tpu_torch.classification import BinaryAUROC, BinaryPrecisionRecallCurve, BinaryROC
    from metrics_tpu_torch.core.state import CatBuffer
    from metrics_tpu_torch.ops import rank
    from metrics_tpu_torch.wrappers import BootStrapper

    cfg = DLRM_PURE
    batches = dlrm_style_batches(torch, seed + 1500, cfg["updates"], cfg["batch"])
    boot = BootStrapper(BinaryAUROC(cat_capacity=cfg["capacity"]), num_bootstraps=cfg["num_bootstraps"],
                        raw=True, seed=seed)

    def updates():
        state = boot.init_state()
        for batch in batches:
            state = boot.local_update(state, *batch)
        return state

    state, counted, update_s = run_counted(torch, updates)
    expect_launches("DLRM pure BootStrapper updates", counted)
    preds, target = state["metrics"]["preds"], state["metrics"]["target"]
    if preds._count != cfg["capacity"] or preds.overflowed() or preds.data.shape != (cfg["num_bootstraps"],
                                                                                     cfg["capacity"]):
        raise AssertionError(f"DLRM pure BootStrapper buffers: {preds} holding {preds._count}")
    value, counted, compute_s = run_counted(torch, lambda: boot.compute_from(state))
    expect_launches("DLRM pure BootStrapper compute_from", counted, scan=1)
    scan_launches = counted["segment_scan"]
    tiers = {}
    for tier in ("rank", "sort"):
        with rank.force_tier(tier):
            tiers[tier] = boot.compute_from(state)["raw"]
    if not (torch.equal(tiers["rank"], tiers["sort"]) and torch.equal(tiers["rank"], value["raw"])):
        raise AssertionError(f"DLRM pure BootStrapper: the rank and sort tiers differ {tiers}")
    eager_err, f64_err = 0.0, 0.0
    for k in range(cfg["num_bootstraps"]):
        one = BinaryAUROC()
        one.update(preds.data[k], target.data[k])
        eager_err = max(eager_err, abs(value["raw"][k].item() - one.compute().item()))
        f64_err = max(f64_err, abs(value["raw"][k].item() - mann_whitney_auc(torch, preds.data[k], target.data[k])))
    if not (eager_err <= PURE_AUROC_RTOL and f64_err <= AUROC_ATOL):
        raise AssertionError(f"DLRM pure BootStrapper: off its copies' eager computes by {eager_err},"
                             f" off float64 by {f64_err}")
    timing = {"local_update_ms": event_ms(torch, lambda: boot.local_update(state, *batches[0]), reps=5, warmup=1),
              "compute_from_ms": event_ms(torch, lambda: boot.compute_from(state), reps=5, warmup=1),
              "compute_from_device": call_device_ms(torch, lambda: boot.compute_from(state), "segment_scan", reps=3)}
    timing["scan_batched"] = batched_scan_timing(torch, cfg["num_bootstraps"] * preds._count, preds._count)
    # the traced curves over the first copies' buffers, one vmap each, against the eager curves
    count, copies = preds._count, cfg["curve_copies"]
    curves = {}
    for cls in (BinaryPrecisionRecallCurve, BinaryROC):
        metric = cls(cat_capacity=cfg["capacity"])

        def traced(p, t, metric=metric):
            return metric.compute_from({"preds": CatBuffer(p, count), "target": CatBuffer(t, count)})

        got, counted, _ = run_counted(torch, lambda: torch.func.vmap(traced)(preds.data[:copies],
                                                                             target.data[:copies]))
        expect_launches(f"traced {cls.__name__} of {copies} copies", counted, scan=1)
        scan_launches += counted["segment_scan"]
        ks = []
        for k in range(copies):
            eager = cls()
            eager.update(preds.data[k], target.data[k])
            want = eager.compute()
            kk = int((~torch.isnan(got[2][k])).sum())
            if kk != want[2].numel() or not all(torch.equal(g[k][:kk], w[:kk]) for g, w in zip(got, want)):
                raise AssertionError(f"traced {cls.__name__} copy {k}: the first {kk} entries differ from the"
                                     f" eager curve of {want[2].numel()} points")
            ks.append(kk)
        curves[cls.__name__] = {"points": ks, "padded_length": int(got[0].shape[1])}
    record = {"rows_per_copy": count, "updates": len(batches), "num_bootstraps": cfg["num_bootstraps"],
              "scan_launches_per_compute_from": 1, "tiers_equal": True, "max_abs_err_vs_eager": eager_err,
              "eager_tol": PURE_AUROC_RTOL, "max_abs_err_vs_float64": f64_err, "atol": AUROC_ATOL,
              "values": {k: v.tolist() for k, v in value.items()}, "traced_curves": curves, "timing": timing,
              "scan_launches": scan_launches, "seconds": {"updates": update_s, "compute_from": compute_s}}
    emit({"phase": "wrappers_stacked", "config": "dlrm_pure", "nvidia_smi": smi, **record})
    return record


def ws_qm9(torch, seed: int, smi: str) -> None:
    """MultioutputWrapper(PearsonCorrCoef(), 12, remove_nans=False) through the pure tier
    over QM9 in updates of 32, against the eager wrapper."""
    from metrics_tpu_torch.regression import PearsonCorrCoef
    from metrics_tpu_torch.wrappers import MultioutputWrapper

    preds, target = qm9_data(torch, seed)
    n, c, b = preds.shape[0], preds.shape[1], QM9["batch"]
    batches = [(preds[s:s + b], target[s:s + b]) for s in range(0, n, b)]
    pure = MultioutputWrapper(PearsonCorrCoef(), c, remove_nans=False)

    def drive():
        state = pure.init_state()
        for batch in batches:
            state = pure.local_update(state, *batch)
        return state, pure.compute_from(state)

    (state, value), counted, seconds = run_counted(torch, drive)
    expect_launches("QM9 pure MultioutputWrapper", counted)
    eager = MultioutputWrapper(PearsonCorrCoef(), c, remove_nans=False)
    for batch in batches:
        eager.update(*batch)
    err = (value.double() - eager.compute().double()).abs().max().item()
    if not err <= QM9_ATOL:
        raise AssertionError(f"QM9 pure MultioutputWrapper off the eager wrapper by {err}")
    emit({"phase": "wrappers_stacked", "config": "qm9_multioutput_pure", "nvidia_smi": smi, "molecules": n,
          "targets": c, "updates": len(batches), "max_abs_err_vs_eager": err, "atol": QM9_ATOL, "seconds": seconds,
          "local_update_ms": event_ms(torch, lambda: pure.local_update(state, *batches[0]), reps=20)})


def ws_cifar_fleet(torch, seed: int, smi: str) -> int:
    """ClasswiseWrapper over a 16-stream MulticlassAccuracy(10, None) fleet: 20 routed
    updates of 10,000 rows, bit-equal to 16 plain metrics. Returns the batched launches."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.core.fleet import step_stats
    from metrics_tpu_torch.wrappers import ClasswiseWrapper

    size, c, rows = ENGINES["fleet_size"], ENGINES["classes"], ENGINES["fleet_rows"]
    g = torch.Generator(device="cuda").manual_seed(seed + 1600)
    updates = [tuple(torch.randint(0, k, (rows,), generator=g, device="cuda") for k in (c, c, size))
               for _ in range(ENGINES["fleet_updates"])]
    wrapper = ClasswiseWrapper(MulticlassAccuracy(num_classes=c, average=None, fleet_size=size))
    def drive():
        for p, t, i in updates:
            wrapper.update(p, t, stream_ids=i)
        return wrapper.compute()

    out, counted, seconds = run_counted(torch, drive)
    expect_launches("CIFAR-10 fleet ClasswiseWrapper", counted, batched=len(updates) + 1)
    if step_stats(wrapper.metric)["degrades"]:
        raise AssertionError(f"CIFAR-10 fleet ClasswiseWrapper steps: {step_stats(wrapper.metric)}")
    refs = [MulticlassAccuracy(num_classes=c, average=None) for _ in range(size)]
    for p, t, i in updates:
        for s in range(size):
            refs[s].update(p[i == s], t[i == s])
    if list(out) != [f"multiclassaccuracy_{j}" for j in range(c)]:
        raise AssertionError(f"CIFAR-10 fleet ClasswiseWrapper keys {list(out)}")
    for s, ref in enumerate(refs):
        want = ref.compute()
        if not all(torch.equal(out[f"multiclassaccuracy_{j}"][s], want[j]) for j in range(c)):
            raise AssertionError(f"CIFAR-10 fleet ClasswiseWrapper stream {s} differs from its plain metric")
    p, t, i = updates[0]
    emit({"phase": "wrappers_stacked", "config": "cifar10_fleet_classwise", "nvidia_smi": smi, "fleet_size": size,
          "classes": c, "rows": rows, "updates": len(updates), "bit_equal_to_plain_metrics": True,
          "batched_launches": counted["histogram_batched"], "steps": step_stats(wrapper.metric), "seconds": seconds,
          "update_ms": event_ms(torch, lambda: wrapper.update(p, t, stream_ids=i), reps=20)})
    return counted["histogram_batched"]


def ws_minmax_fleet(torch, seed: int, smi: str) -> int:
    """MinMaxMetric over a MulticlassAccuracy(10) base with ``fleet_size=16``: its steps
    update the shared base eagerly, once per batch. 5 updates of 10,000 rows, each
    compute held against a plain base fed the same batches. Returns the histogram's
    launches."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.wrappers import MinMaxMetric

    size, c, rows = ENGINES["fleet_size"], ENGINES["classes"], ENGINES["fleet_rows"]
    g = torch.Generator(device="cuda").manual_seed(seed + 1700)
    updates = [tuple(torch.randint(0, c, (rows,), generator=g, device="cuda") for _ in range(2)) for _ in range(5)]
    wrapper, base = MinMaxMetric(MulticlassAccuracy(num_classes=c), fleet_size=size), MulticlassAccuracy(num_classes=c)

    def drive():
        return [(wrapper.update(p, t), wrapper.compute())[1] for p, t in updates]

    outs, counted, seconds = run_counted(torch, drive)
    expect_launches("MinMaxMetric fleet", counted, histogram=len(updates))
    values = []
    for (p, t), out in zip(updates, outs):
        base.update(p, t)
        values.append(base.compute())
        want = {"raw": values[-1], "max": torch.stack(values).max(), "min": torch.stack(values).min()}
        if not all(torch.equal(out[k], v.expand(size)) for k, v in want.items()):
            raise AssertionError(f"MinMaxMetric fleet: {out} differs from its plain base's {want}")
    emit({"phase": "wrappers_stacked", "config": "minmax_fleet", "nvidia_smi": smi, "fleet_size": size,
          "classes": c, "rows": rows, "updates": len(updates), "equal_to_plain_base": True, "seconds": seconds})
    return counted["histogram"]


def phase_wrappers_stacked(torch, seed: int, smi: str):
    """The wrappers' stacked paths and pure tier: the stacked BootStrapper on ImageNet,
    the pure tier of exact-AUROC copies on DLRM-style rows with the traced curves, the
    pure MultioutputWrapper on QM9, the fleet ClasswiseWrapper on CIFAR-10 and a fleet
    MinMaxMetric. Returns the histogram's, the batched histogram's and the scan's
    launches on this path."""
    t0 = time.perf_counter()
    imagenet = ws_imagenet(torch, seed, smi)
    torch.cuda.empty_cache()
    dlrm = ws_dlrm_pure(torch, seed, smi)
    torch.cuda.empty_cache()
    ws_qm9(torch, seed, smi)
    fleet = ws_cifar_fleet(torch, seed, smi)
    minmax = ws_minmax_fleet(torch, seed, smi)
    launches = {"histogram": minmax, "histogram_batched": imagenet["batched_launches"] + fleet,
                "segment_scan": dlrm["scan_launches"]}
    emit({"phase": "wrappers_stacked", "config": "all", "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# ----------------------------------------------------------------- sketches

# the DLRM stream and Criteo's categorical ids (MLPerf DLRM's --max-ind-range cap), updates of 65,536
SKETCH_DLRM = {"tolerance": 1e-3, "tolerance_bits": 14, "drift_bins": 64, "exact_capacity": 1 << 27}
SKETCH_IDS = {"id_range": 40_000_000, "p": (12, 14), "cpu_chunk": 1 << 23}
SKETCH_IMAGENET = {"batch": 256, "tolerance": 1e-2, "checked_updates": 3}
SKETCH_ENGINES = {"fused_steps": 200, "fleet_size": 16, "fleet_rows": 10_000, "fleet_updates": 20}
BRACKET_ATOL = 1e-6  # the brackets' float32 pair arithmetic (the JAX package's) against the exact values
QUANTILE_SLACK = 1e-5  # relative, beyond the certified α: float32 bucket edges and midpoints


def timed_updates(torch, metric, batches, *extra) -> list:
    """``metric.update`` over ``batches``, each bracketed by CUDA events (no sync in
    between); returns the device ms of each update."""
    pairs = []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metric.update(*batch, *extra)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def update_profile(torch, fn, reps: int = 10) -> dict:
    """Device launches and device ms per ``fn()`` call from a profiler trace, and the
    call's event ms: its device share says how far the host holds the card back."""
    launches = device_launches(profile_window(torch, fn, reps))
    device = sum(us for _, us in launches.values()) / reps / 1e3
    event = event_ms(torch, fn)
    return {"launches_per_call": sum(n for n, _ in launches.values()) / reps, "device_ms": device,
            "event_ms": event, "device_share": device / event}


def bracket_check(label: str, lo, hi, mid, exact) -> dict:
    """``exact`` inside [lo, hi] and ``mid`` within width/2 of it, within BRACKET_ATOL."""
    lo, hi, mid, exact = (float(v) for v in (lo, hi, mid, exact))
    if not (lo - BRACKET_ATOL <= exact <= hi + BRACKET_ATOL and abs(mid - exact) <= (hi - lo) / 2 + BRACKET_ATOL):
        raise AssertionError(f"{label}: exact {exact} outside [{lo}, {hi}] or mid {mid} too far")
    return {"lower": lo, "upper": hi, "mid": mid, "exact": exact, "width": hi - lo, "abs_err": abs(mid - exact)}


def sketch_plain_states(torch, scores, target, half_rows: int, qs, drift) -> dict:
    """The DLRM sketch states from the plain histogram over the whole stream at once."""
    from metrics_tpu_torch.ops.histogram import _plain_bincount
    from metrics_tpu_torch.ops.rank import monotone_key_descending
    from metrics_tpu_torch.ops.sketch import log_bucket_index

    nb_auc = 1 << SKETCH_DLRM["tolerance_bits"]
    ids = (monotone_key_descending(scores) >> (32 - SKETCH_DLRM["tolerance_bits"])).to(torch.int32)
    pos = _plain_bincount(ids, target == 1, nb_auc)
    out = {"pos_hist": pos, "neg_hist": _plain_bincount(ids, None, nb_auc) - pos}
    del ids
    nb = 1 << qs.bits
    idx = log_bucket_index(scores.abs(), qs._log_gamma, qs.min_value, nb)
    in_range = (idx >= 0) & (idx < nb)
    out["pos_buckets"] = _plain_bincount(idx, (scores > 0) & in_range, nb)
    out["neg_buckets"] = _plain_bincount(idx, (scores < 0) & in_range, nb)
    del idx, in_range
    scale = torch.tensor(drift.num_bins / (drift.high - drift.low), dtype=torch.float32)
    slot = torch.clamp(torch.floor((scores - drift.low) * scale), -1.0, float(drift.num_bins)).to(torch.int32) + 1
    out["ref_hist"] = _plain_bincount(slot[:half_rows], None, drift.num_bins + 2)
    out["live_hist"] = _plain_bincount(slot[half_rows:], None, drift.num_bins + 2)
    return out


def sk_dlrm(torch, seed: int, smi: str) -> dict:
    """Criteo day 23 through the tolerance-routed AUROC and AP, StreamingAUROCBound,
    QuantileSketch and HistogramDrift; the exact tier on the same stream."""
    import warnings

    from metrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision
    from metrics_tpu_torch.ops.rank import hist_ap_bounds, hist_auroc_bounds
    from metrics_tpu_torch.sketches import HistogramDrift, QuantileSketch, StreamingAUROCBound

    scores, target = dlrm_data(torch, seed)
    n = scores.numel()
    batches = dlrm_batches(scores, target, n)
    half = len(batches) // 2
    half_rows = half * DLRM["batch"]
    tol, bits = SKETCH_DLRM["tolerance"], SKETCH_DLRM["tolerance_bits"]
    routed = {"BinaryAUROC": BinaryAUROC(tolerance=tol, tolerance_bits=bits),
              "BinaryAveragePrecision": BinaryAveragePrecision(tolerance=tol, tolerance_bits=bits),
              "StreamingAUROCBound": StreamingAUROCBound(bits=bits)}
    qs = QuantileSketch()
    drift = HistogramDrift(num_bins=SKETCH_DLRM["drift_bins"])

    def stream():
        times = {name: timed_updates(torch, m, batches) for name, m in routed.items()}
        times["QuantileSketch"] = timed_updates(torch, qs, [(p,) for p, _ in batches])
        times["HistogramDrift"] = (timed_updates(torch, drift, [(p,) for p, _ in batches[:half]], True)
                                   + timed_updates(torch, drift, [(p,) for p, _ in batches[half:]]))
        return times

    times, counted, stream_s = run_counted(torch, stream)
    # two mask-mode launches an update for each class-histogram metric and QuantileSketch, one for drift
    expect_launches("DLRM sketch updates", counted, histogram=9 * len(batches))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        values, counted_compute, _ = run_counted(
            torch, lambda: {**{k: m.compute() for k, m in routed.items()}, "QuantileSketch": qs.compute(),
                            "HistogramDrift": drift.compute()})
    expect_launches("DLRM sketch computes", counted_compute)
    width_warnings = [str(w.message) for w in caught if "exceeds tolerance" in str(w.message)]

    # bit-equal to the plain histogram of the whole stream
    plain = sketch_plain_states(torch, scores, target, half_rows, qs, drift)
    states = {"pos_hist": [m.pos_hist for m in routed.values()], "neg_hist": [m.neg_hist for m in routed.values()],
              "pos_buckets": [qs.pos_buckets], "neg_buckets": [qs.neg_buckets],
              "ref_hist": [drift.ref_hist], "live_hist": [drift.live_hist]}
    for name, got in states.items():
        if not all(g.dtype == torch.int32 and torch.equal(g, plain[name]) for g in got):
            raise AssertionError(f"DLRM sketch state {name} differs from the plain histogram")
    del plain
    edges = qs.edge_counts.tolist()
    if edges != [0, 0, int((scores == 0).sum()), 0, 0] or int(qs.nan_count) != 0:
        raise AssertionError(f"QuantileSketch edge counts {edges}, NaN count {int(qs.nan_count)}")

    # the exact tier on the same stream
    exact = {"BinaryAUROC": BinaryAUROC(cat_capacity=SKETCH_DLRM["exact_capacity"]),
             "BinaryAveragePrecision": BinaryAveragePrecision(cat_capacity=SKETCH_DLRM["exact_capacity"])}
    for preds, labels in batches:
        for m in exact.values():
            m.update(preds, labels)
    exact_values, exact_counted, _ = run_counted(torch, lambda: {k: m.compute() for k, m in exact.items()})
    expect_launches("DLRM exact computes", exact_counted, scan=2)
    pos, neg = routed["BinaryAUROC"].pos_hist, routed["BinaryAUROC"].neg_hist
    au_lo, au_hi = hist_auroc_bounds(pos, neg)
    ap_lo, ap_hi = hist_ap_bounds(pos, neg)
    brackets = {
        "BinaryAUROC": bracket_check("BinaryAUROC", au_lo, au_hi, values["BinaryAUROC"], exact_values["BinaryAUROC"]),
        "BinaryAveragePrecision": bracket_check("BinaryAveragePrecision", ap_lo, ap_hi,
                                                values["BinaryAveragePrecision"],
                                                exact_values["BinaryAveragePrecision"]),
    }
    bound = values["StreamingAUROCBound"]
    for key, lo, hi in (("auroc", au_lo, au_hi), ("ap", ap_lo, ap_hi)):
        if not (torch.equal(bound[f"{key}_lower"], lo) and torch.equal(bound[f"{key}_upper"], hi)):
            raise AssertionError(f"StreamingAUROCBound's {key} bracket differs from the routed class's")

    # quantiles against the exact order statistics of one sort
    ordered = torch.sort(scores).values
    quantiles = {}
    for level, got, certified in zip(qs.quantiles, values["QuantileSketch"]["quantiles"].tolist(),
                                     values["QuantileSketch"]["certified"].tolist()):
        want = ordered[int(level * (n - 1))].item()
        rel = abs(got - want) / abs(want)
        quantiles[str(level)] = {"sketch": got, "exact": want, "rel_err": rel, "certified": certified}
        if not certified or rel > qs.relative_error + QUANTILE_SLACK:
            raise AssertionError(f"quantile {level}: {got} vs exact {want} (relative {rel})")
    del ordered

    def median(xs):
        return statistics.median(xs)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the width warning, recorded above, at every timed compute
        compute_ms = {name: uncached_compute_ms(torch, m, reps=10)
                      for name, m in {**routed, "QuantileSketch": qs, "HistogramDrift": drift}.items()}
    exact_compute_ms = {name: uncached_compute_ms(torch, m, reps=3) for name, m in exact.items()}
    state_bytes = {name: sum(getattr(m, s).numel() * getattr(m, s).element_size() for s in m._defaults)
                   for name, m in {**routed, "QuantileSketch": qs, "HistogramDrift": drift}.items()}
    exact_bytes = {name: sum(getattr(m, s).data.numel() * getattr(m, s).data.element_size() for s in m._defaults)
                   for name, m in exact.items()}
    record = {
        "samples": n, "updates": len(batches), "reference_updates": half,
        "update_ms_median": {k: median(v) for k, v in times.items()},
        "launches_per_update": {"histogram": counted["histogram"] / len(batches)},
        "stream_s": stream_s, "compute_ms": compute_ms, "exact_compute_ms": exact_compute_ms,
        "brackets": brackets, "tolerance": tol, "tolerance_bits": bits, "width_warnings": width_warnings,
        "quantiles": quantiles, "drift": {k: v.item() for k, v in values["HistogramDrift"].items()},
        "state_bytes": state_bytes, "exact_state_bytes": exact_bytes, "states_bit_equal_to_plain": True,
    }
    # where an update's time goes: fresh metrics, one update of the first batch
    fresh = {"BinaryAUROC": BinaryAUROC(tolerance=tol, tolerance_bits=bits),
             "StreamingAUROCBound": StreamingAUROCBound(bits=bits), "QuantileSketch": QuantileSketch(),
             "HistogramDrift": HistogramDrift(num_bins=SKETCH_DLRM["drift_bins"])}
    first = {name: batches[0] if name in routed else (batches[0][0],) for name in fresh}
    record["update_profile"] = {name: update_profile(torch, lambda m=m, a=first[name]: m.update(*a))
                                for name, m in fresh.items()}
    record["update_profile"]["BinaryAUROC(validate_args=False)"] = update_profile(
        torch, lambda m=BinaryAUROC(tolerance=tol, tolerance_bits=bits, validate_args=False): m.update(*batches[0]))
    emit({"phase": "sketches_dlrm", "card": smi, **record})
    # the mask mode at this path's shape: the positive histogram of one update, 2^14 bins
    from metrics_tpu_torch.ops.rank import monotone_key_descending

    ids = (monotone_key_descending(batches[0][0]) >> (32 - bits)).to(torch.int32)
    mask = batches[0][1] == 1
    record["mask_mode"] = histogram_mode_timing(torch, ids, mask, 1 << bits, mask.float())
    emit({"phase": "sketches_mask_mode", "card": smi, **record["mask_mode"]})
    record["scan_launches"] = exact_counted["segment_scan"]
    record["histogram_launches"] = counted["histogram"]
    record["fused_batches"] = batches[:SKETCH_ENGINES["fused_steps"]]
    return record


def sk_ids(torch, seed: int, smi: str) -> None:
    """Criteo-range categorical ids through DistinctCount at p = 12 and 14, against the
    true distinct count and a CPU run of the port."""
    from metrics_tpu_torch.sketches import DistinctCount

    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    n = DLRM["samples"]
    ids = torch.randint(0, SKETCH_IDS["id_range"], (n,), generator=g, device="cuda")
    batches = [(ids[s:s + DLRM["batch"]],) for s in range(0, n, DLRM["batch"])]
    true = torch.unique(ids).numel()
    out = {}
    for p in SKETCH_IDS["p"]:
        metric = DistinctCount(p=p)
        times, counted, _ = run_counted(torch, lambda: timed_updates(torch, metric, batches))
        expect_launches(f"DistinctCount(p={p}) updates", counted)
        estimate = metric.compute().item()
        limit = 3 * 1.04 / math.sqrt(1 << p)
        rel = abs(estimate - true) / true
        if metric.registers.dtype != torch.uint8 or rel > limit:
            raise AssertionError(f"DistinctCount(p={p}): {estimate} vs {true} distinct ids (relative {rel} > {limit})")
        cpu = DistinctCount(p=p, device="cpu")
        t0 = time.perf_counter()
        for s in range(0, n, SKETCH_IDS["cpu_chunk"]):
            cpu.update(ids[s:s + SKETCH_IDS["cpu_chunk"]].cpu())
        cpu_s = time.perf_counter() - t0
        if not torch.equal(metric.registers.cpu(), cpu.registers):
            raise AssertionError(f"DistinctCount(p={p}): registers differ from the CPU run's")
        profile = update_profile(torch, lambda m=DistinctCount(p=p): m.update(*batches[0]))
        out[p] = {"estimate": estimate, "true": true, "rel_err": rel, "limit_3_sigma": limit, "profile": profile,
                  "update_ms_median": statistics.median(times), "launches_per_update": 0,
                  "state_bytes": metric.state_bytes(), "cpu_run_s": cpu_s, "registers_equal_cpu": True}
    emit({"phase": "sketches_ids", "card": smi, "ids": n, "id_range": SKETCH_IDS["id_range"], "p": out})


def sk_imagenet(torch, seed: int, smi: str) -> dict:
    """ImageNet-1k one-vs-rest through the tolerance-routed AUROC and AP: two batched
    launches an update, the lanes bit-equal to the per-lane loop, every class's exact
    value inside its bracket."""
    import warnings

    from metrics_tpu_torch.classification import MulticlassAUROC, MulticlassAveragePrecision
    from metrics_tpu_torch.ops.histogram import _plain_batched_bincount, histogram_batched_cuda
    from metrics_tpu_torch.ops.rank import (
        _bucket_ids, hist_ap_bounds, hist_auroc_bounds, hist_class_counts, monotone_key_descending,
    )

    gi = torch.Generator(device="cuda").manual_seed(seed + 3)  # the curve phase's ImageNet data
    c, m = IMAGENET["classes"], IMAGENET["samples"]
    probs = torch.softmax(2.0 * torch.randn((m, c), generator=gi, device="cuda"), dim=1)
    labels = torch.randint(0, c, (m,), generator=gi, device="cuda")
    b = SKETCH_IMAGENET["batch"]
    batches = [(probs[s:s + b], labels[s:s + b]) for s in range(0, m, b)]
    tol = SKETCH_IMAGENET["tolerance"]
    routed = {"MulticlassAUROC": MulticlassAUROC(c, average=None, tolerance=tol),
              "MulticlassAveragePrecision": MulticlassAveragePrecision(c, average=None, tolerance=tol)}
    bits = routed["MulticlassAUROC"].tolerance_bits
    checked = SKETCH_IMAGENET["checked_updates"]

    times, counted, _ = run_counted(torch, lambda: {k: timed_updates(torch, mt, batches[:checked])
                                                    for k, mt in routed.items()})
    expect_launches("ImageNet routed updates (first 3)", counted, batched=2 * len(routed) * checked)
    # the per-lane loop of the JAX package: 2 single launches a class (comparison launches, not counted)
    saved = all_launches()
    lanes_pos = torch.zeros((c, 1 << bits), dtype=torch.int32, device="cuda")
    lanes_neg = torch.zeros_like(lanes_pos)
    for preds, target in batches[:checked]:
        for k in range(c):
            p, q = hist_class_counts(preds[:, k], target == k, target >= 0, bits)
            lanes_pos[k] += p
            lanes_neg[k] += q
    for wrapper_name, wrapper in kernel_wrappers().items():
        wrapper.launches = saved[wrapper_name]
    for name, mt in routed.items():
        if not (torch.equal(mt.pos_hist, lanes_pos) and torch.equal(mt.neg_hist, lanes_neg)):
            raise AssertionError(f"{name}: the batched lanes differ from the per-lane loop after {checked} updates")
    more, counted_rest, _ = run_counted(torch, lambda: {k: timed_updates(torch, mt, batches[checked:])
                                                        for k, mt in routed.items()})
    expect_launches("ImageNet routed updates", counted_rest, batched=2 * len(routed) * (len(batches) - checked))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        values = {k: mt.compute() for k, mt in routed.items()}
    width_warnings = [str(w.message) for w in caught if "exceeds tolerance" in str(w.message)]

    exact = {"MulticlassAUROC": MulticlassAUROC(c, average=None),
             "MulticlassAveragePrecision": MulticlassAveragePrecision(c, average=None)}
    for preds, target in batches:
        for mt in exact.values():
            mt.update(preds, target)
    exact_values, exact_counted, _ = run_counted(torch, lambda: {k: mt.compute() for k, mt in exact.items()})
    expect_launches("ImageNet exact computes", exact_counted, scan=2 * c)
    worst = {}
    for name, bounds in (("MulticlassAUROC", hist_auroc_bounds), ("MulticlassAveragePrecision", hist_ap_bounds)):
        lo, hi = bounds(routed[name].pos_hist, routed[name].neg_hist)
        want, got = exact_values[name], values[name]
        inside = (want >= lo - BRACKET_ATOL) & (want <= hi + BRACKET_ATOL)
        near = (got - want).abs() <= (hi - lo) / 2 + BRACKET_ATOL
        if not bool((inside & near).all()):
            raise AssertionError(f"{name}: {int((~(inside & near)).sum())} classes outside their brackets")
        worst[name] = {"max_width": (hi - lo).max().item(), "mean_width": (hi - lo).mean().item(),
                       "max_abs_err": (got - want).abs().max().item()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the width warning, counted above, at every timed compute
        compute_ms = {k: uncached_compute_ms(torch, mt, reps=5) for k, mt in routed.items()}
    # the batched mode at this path's shape: one update's (1,000, 256) bucket ids, 4,096 bins
    preds, target = batches[0]
    ids = _bucket_ids(monotone_key_descending(preds).t(), bits).contiguous()
    mask = (target.unsqueeze(0) == torch.arange(c, device="cuda").unsqueeze(1)).contiguous()
    got = histogram_batched_cuda(ids, mask, 1 << bits)
    if not torch.equal(got, _plain_batched_bincount(ids, mask, 1 << bits)):
        raise AssertionError("batched mask mode != plain at the one-vs-rest shape")
    total = c << bits
    flat = (ids.long() + torch.arange(c, device="cuda").unsqueeze(1) * (1 << bits)).reshape(-1)
    device = call_device_ms(torch, lambda: histogram_batched_cuda(ids, mask, 1 << bits), "histogram_batched")
    batched = {
        "shape": [c, ids.shape[1], 1 << bits], "max_abs_err": 0,
        "event_ms": event_ms(torch, lambda: histogram_batched_cuda(ids, mask, 1 << bits)),
        "device_ms": None if device is None else device["device_ms"],
        "kernel_ms": None if device is None else device["hand_kernels_ms"],
        "memset_ms": None if device is None else device["memset_ms"],
        "plain_ms": event_ms(torch, lambda: _plain_batched_bincount(ids, mask, 1 << bits)),
        "library_ms": event_ms(torch, lambda: torch.bincount(flat, weights=mask.reshape(-1).float(),
                                                             minlength=total)),
        "bound_ms": (ids.numel() * 5 + total * 4) / HBM_BYTES_PER_S * 1e3,
    }
    record = {
        "samples": m, "classes": c, "updates": len(batches), "tolerance": tol, "tolerance_bits": bits,
        "update_ms_median": {k: statistics.median(times[k] + more[k]) for k in routed},
        "batched_launches_per_update": 2, "lanes_equal_per_lane_loop_updates": checked,
        "compute_ms": compute_ms,
        "exact_compute_ms_pr4_pr6": {"MulticlassAUROC": 984.9811401367188,
                                     "MulticlassAveragePrecision": 1082.26416015625},
        "state_bytes": {k: sum(getattr(mt, s).numel() * getattr(mt, s).element_size() for s in mt._defaults)
                        for k, mt in routed.items()},
        "exact_state_bytes": sum(x.numel() * x.element_size() for x in exact["MulticlassAUROC"].preds)
        + sum(x.numel() * x.element_size() for x in exact["MulticlassAUROC"].target),
        "brackets": worst, "width_warnings": len(width_warnings), "batched_mode": batched,
    }
    emit({"phase": "sketches_imagenet", "card": smi, **record})
    record["batched_launches"] = counted["histogram_batched"] + counted_rest["histogram_batched"]
    record["scan_launches"] = exact_counted["segment_scan"]
    return record


def sk_engines(torch, seed: int, smi: str, batches) -> dict:
    """The three DLRM sketch-tier metrics fused over 200 updates, bit-equal to eager; a
    16-stream DistinctCount fleet bit-equal to 16 sketches."""
    from metrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.core.fleet import step_stats
    from metrics_tpu_torch.core.fused import engine_for
    from metrics_tpu_torch.sketches import DistinctCount, StreamingAUROCBound

    tol, bits = SKETCH_DLRM["tolerance"], SKETCH_DLRM["tolerance_bits"]

    def three():
        return {"auroc": BinaryAUROC(tolerance=tol, tolerance_bits=bits),
                "ap": BinaryAveragePrecision(tolerance=tol, tolerance_bits=bits),
                "bound": StreamingAUROCBound(bits=bits)}

    fused, eager = MetricCollection(three(), fused=True), three()
    _, fused_counted, fused_s = run_counted(torch, lambda: [fused.update(p, t) for p, t in batches])
    _, eager_counted, _ = run_counted(torch, lambda: [mt.update(p, t) for p, t in batches for mt in eager.values()])
    # the eager step's launches, run once by the capture's warm-up and once by each replay
    per_step = fused_counted["histogram"] // (len(batches) + 1)
    expect_launches("fused sketch collection", fused_counted, histogram=per_step * (len(batches) + 1))
    expect_launches("eager sketch metrics", eager_counted, histogram=6 * len(batches))
    stats = dict(engine_for(fused).stats)
    if stats["launches"] != len(batches) or stats["degrades"] or stats["fallback_groups"]:
        raise AssertionError(f"fused sketch collection: stats {stats}")
    for name, mt in eager.items():
        for state in mt._defaults:
            if not torch.equal(getattr(fused[name], state), getattr(mt, state)):
                raise AssertionError(f"fused {name}.{state} differs from eager")
    step_ms = event_ms(torch, lambda: fused.update(*batches[0]), reps=50)
    eager_ms = event_ms(torch, lambda: [mt.update(*batches[0]) for mt in eager.values()], reps=50)

    g = torch.Generator(device="cuda").manual_seed(seed + 37)
    size, rows = SKETCH_ENGINES["fleet_size"], SKETCH_ENGINES["fleet_rows"]
    updates = [(torch.randint(0, SKETCH_IDS["id_range"], (rows,), generator=g, device="cuda"),
                torch.randint(0, size, (rows,), generator=g, device="cuda"))
               for _ in range(SKETCH_ENGINES["fleet_updates"])]
    fleet = DistinctCount(p=12, fleet_size=size)
    _, fleet_counted, _ = run_counted(torch, lambda: [fleet.update(x, stream_ids=i) for x, i in updates])
    expect_launches("DistinctCount fleet", fleet_counted)
    apart = [DistinctCount(p=12) for _ in range(size)]
    for x, i in updates:
        for s in range(size):
            apart[s].update(x[i == s])
    if step_stats(fleet)["launches"] != len(updates) or step_stats(fleet)["degrades"]:
        raise AssertionError(f"DistinctCount fleet steps: {step_stats(fleet)}")
    if not all(torch.equal(fleet.registers[s], apart[s].registers) for s in range(size)):
        raise AssertionError("the DistinctCount fleet differs from 16 separate sketches")
    x, i = updates[0]
    record = {"fused_steps": len(batches), "fused_stats": stats, "fused_launches": fused_counted,
              "fused_update_ms": step_ms, "eager_three_updates_ms": eager_ms, "fused_host_s": fused_s,
              "fleet": {"size": size, "rows": rows, "updates": len(updates), "steps": step_stats(fleet),
                        "update_ms": event_ms(torch, lambda: fleet.update(x, stream_ids=i), reps=20),
                        "bit_equal_to_separate": True}}
    emit({"phase": "sketches_engines", "card": smi, **record})
    return record


def phase_sketches(torch, seed: int, smi: str):
    """The sketch family and the tolerance tier: the DLRM stream, Criteo ids, ImageNet
    one-vs-rest and the engines. Returns the mask-mode and batched-mode timing records
    and the histogram's, the batched histogram's and the scan's launches on this path."""
    t0 = time.perf_counter()
    dlrm = sk_dlrm(torch, seed, smi)
    fused_batches = dlrm.pop("fused_batches")
    engines = sk_engines(torch, seed, smi, fused_batches)
    del fused_batches
    torch.cuda.empty_cache()
    sk_ids(torch, seed, smi)
    torch.cuda.empty_cache()
    imagenet = sk_imagenet(torch, seed, smi)
    torch.cuda.empty_cache()
    launches = {"histogram": dlrm["histogram_launches"] + engines["fused_launches"]["histogram"],
                "histogram_batched": imagenet["batched_launches"],
                "segment_scan": dlrm["scan_launches"] + imagenet["scan_launches"]}
    emit({"phase": "sketches", "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


LIBRISPEECH = {"utterances": 2_620, "words": (5, 35), "vocab": 10_000, "noise": 0.1, "batch": 64}
WMT14 = {"sentences": 3_003, "words": (5, 40), "noise": 0.15, "batch": 64, "eed_sentences": 300}
CNNDM = {"articles": 3_000, "sentences": (3, 4), "words": (12, 18), "noise": 0.3, "batch": 64}
SQUAD = {"questions": 10_570, "answers": (1, 3), "words": (1, 5), "batch": 1_000}
GPT2 = {"batch": 8, "context": 1_024, "vocab": 50_257, "ignore_rate": 0.1, "ignore_index": -100, "scale": 2.0,
        "target_boost": 10.0}  # logits N(0, 2^2), the target's raised by 10: a perplexity of tens, as a trained LM
TEXT_ATOL = 1e-6  # a string metric's value on the card against the port's CPU run on the same strings
PPL_REL = 1e-5  # Perplexity on the card against the port's CPU run on the same logits, relative
TEXT_TASKS = {  # the CPU check's groups of string metrics, one worker process each
    "wer": ("WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved"),
    "bleu": ("BLEUScore", "SacreBLEUScore-13a", "SacreBLEUScore-intl", "SacreBLEUScore-intl_fallback",
             "SacreBLEUScore-char"),
    "chrf_ter": ("CHRFScore-chrF", "CHRFScore-chrF++", "TranslationEditRate"),
    "eed": ("ExtendedEditDistance",),
    "rouge": ("ROUGEScore",),
    "squad": ("SQuAD",),
}


def text_vocab(rng, size: int) -> list:
    """``size`` seeded words of 2-10 lowercase letters, one in 20 with punctuation, a
    number or a capital, so that the 13a and intl tokenizers have work to do."""
    import numpy as np

    lengths = rng.integers(2, 11, size)
    letters = rng.integers(0, 26, int(lengths.sum())).astype(np.uint8) + ord("a")
    words = [chunk.tobytes().decode() for chunk in np.split(letters, np.cumsum(lengths)[:-1])]
    marks = ("{},", "{}.", "{}!", "{}?", "({})", '"{}"', "{}'s", "{}-{}", "{}%", "${}", "{} 1,000", "{} 3.5")
    for i in rng.choice(size, size // 20, replace=False):
        words[i] = marks[i % len(marks)].format(words[i], words[(i + 1) % size]).capitalize()
    return words


def noisy_copy(rng, words: list, vocab: list, rate: float) -> list:
    """``words`` with seeded substitutions, insertions and deletions, each at ``rate`` / 3."""
    out = []
    draws = rng.random(len(words))
    picks = rng.integers(0, len(vocab), len(words))
    for word, r, pick in zip(words, draws, picks):
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(vocab[pick])
            continue
        out.append(word)
        if r < rate:
            out.append(vocab[(pick * 7 + 1) % len(vocab)])
    return out


def text_corpora(seed: int) -> dict:
    """Every string input of phase_text, drawn from one seeded numpy generator: the same
    strings in the card's run and in the CPU check's worker processes."""
    import numpy as np

    rng = np.random.default_rng(seed + 61)
    vocab = text_vocab(rng, LIBRISPEECH["vocab"])

    def sentences(n, lo, hi):
        return [[vocab[i] for i in rng.integers(0, len(vocab), rng.integers(lo, hi + 1))] for _ in range(n)]

    out = {}
    refs = sentences(LIBRISPEECH["utterances"], *LIBRISPEECH["words"])
    out["librispeech"] = ([" ".join(noisy_copy(rng, r, vocab, LIBRISPEECH["noise"])) for r in refs],
                          [" ".join(r) for r in refs])
    refs = sentences(WMT14["sentences"], *WMT14["words"])
    out["wmt14"] = ([" ".join(noisy_copy(rng, r, vocab, WMT14["noise"])) for r in refs], [[" ".join(r)] for r in refs])
    summaries = []
    for _ in range(CNNDM["articles"]):
        parts = sentences(int(rng.integers(CNNDM["sentences"][0], CNNDM["sentences"][1] + 1)), *CNNDM["words"])
        summaries.append(parts)
    out["cnndm"] = (
        [" ".join(" ".join(noisy_copy(rng, s, vocab, CNNDM["noise"])) + "." for s in parts) for parts in summaries],
        [[" ".join(" ".join(s) + "." for s in parts)] for parts in summaries],
    )
    preds, targets = [], []
    for q in range(SQUAD["questions"]):
        answers = [" ".join(s) for s in sentences(int(rng.integers(SQUAD["answers"][0], SQUAD["answers"][1] + 1)),
                                                  *SQUAD["words"])]
        r = rng.random()
        text = answers[0] if r < 0.6 else " ".join(noisy_copy(rng, answers[-1].split(), vocab, 0.5)) if r < 0.85 \
            else vocab[int(rng.integers(len(vocab)))]
        preds.append({"prediction_text": text, "id": str(q)})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(q)})
    out["squad"] = (preds, targets)
    return out


def text_metric(name: str, device: str):
    """The string metric that phase_text runs under ``name``, and its corpus."""
    from metrics_tpu_torch import text

    base, _, variant = name.partition("-")
    if base == "SacreBLEUScore":
        return text.SacreBLEUScore(tokenize=variant.split("_")[0], device=device), "wmt14"
    if base == "CHRFScore":
        return text.CHRFScore(n_word_order=0 if variant == "chrF" else 2, device=device), "wmt14"
    if base == "ROUGEScore":
        return text.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), device=device), "cnndm"
    corpus = {"SQuAD": "squad", "BLEUScore": "wmt14", "TranslationEditRate": "wmt14",
              "ExtendedEditDistance": "wmt14"}.get(base, "librispeech")
    return getattr(text, base)(device=device), corpus


@contextlib.contextmanager
def intl_fallback(active: bool):
    """The ``intl`` tokenizer's ``unicodedata`` fallback while ``active``, whether or not
    ``regex`` is installed."""
    from metrics_tpu_torch.functional.text import sacre_bleu

    saved = sacre_bleu._REGEX_AVAILABLE
    sacre_bleu._REGEX_AVAILABLE = saved and not active
    try:
        yield
    finally:
        sacre_bleu._REGEX_AVAILABLE = saved


def text_run(torch, name: str, corpora: dict, device: str) -> dict:
    """One string metric over its corpus in updates of its batch: the host ms of each
    update (the device's work included), the states as numpy and the value."""
    import numpy as np

    metric, corpus = text_metric(name, device)
    preds, targets = corpora[corpus]
    size = {"librispeech": LIBRISPEECH, "wmt14": WMT14, "cnndm": CNNDM, "squad": SQUAD}[corpus]["batch"]
    n = WMT14["eed_sentences"] if name == "ExtendedEditDistance" else len(preds)
    update_ms = []
    with intl_fallback(name.endswith("_fallback")):
        for i in range(0, n, size):
            t0 = time.perf_counter()
            metric.update(preds[i : min(i + size, n)], targets[i : min(i + size, n)])
            if device != "cpu":
                torch.cuda.synchronize()
            update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    value = metric.compute()
    compute_ms = (time.perf_counter() - t0) * 1e3

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else {k: host(v) for k, v in x.items()} \
            if isinstance(x, dict) else [host(v) for v in x]

    states = {}
    for state in metric._defaults:
        v = getattr(metric, state)
        states[state] = host(torch.cat([t.reshape(-1) for t in v]) if isinstance(v, list) and v else v)
    return {"rows": n, "updates": len(update_ms), "update_ms_median": float(np.median(update_ms)),
            "update_ms_total": float(np.sum(update_ms)), "compute_ms": compute_ms, "states": states,
            "value": host(value), "device": str(metric.device)}


def text_cpu_task(task: str, seed: int) -> dict:
    """One group of TEXT_TASKS on the CPU, in a worker process of phase_text."""
    import torch

    torch.set_num_threads(1)
    corpora = text_corpora(seed)
    return {name: text_run(torch, name, corpora, "cpu") for name in TEXT_TASKS[task]}


def text_compare(np, name: str, card: dict, cpu: dict) -> float:
    """The card run's states bit-equal to the CPU run's; the largest value difference."""
    for state, want in cpu["states"].items():
        got = card["states"][state]
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: state `{state}` on the card differs from the CPU run")

    def flat(v):
        return np.concatenate([flat(v[k]) for k in sorted(v)]) if isinstance(v, dict) else \
            np.concatenate([flat(x) for x in v]) if isinstance(v, list) else np.atleast_1d(v).astype(np.float64)

    err = float(np.max(np.abs(flat(card["value"]) - flat(cpu["value"]))))
    if not err <= TEXT_ATOL:
        raise AssertionError(f"{name}: value on the card {card['value']} against the CPU run's {cpu['value']}")
    return err


def text_strings(torch, seed: int, smi: str) -> dict:
    """The string metrics on the card, held against the port's CPU run in worker
    processes that run at the same time; the WER family's functionals on the whole set."""
    import concurrent.futures
    import importlib.util
    import multiprocessing

    import numpy as np

    from metrics_tpu_torch.functional import text as ftext

    t0 = time.perf_counter()
    corpora = text_corpora(seed)
    corpora_s = time.perf_counter() - t0
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {task: pool.submit(text_cpu_task, task, seed) for task in TEXT_TASKS}
        card = {name: text_run(torch, name, corpora, "cuda") for names in TEXT_TASKS.values() for name in names}
        functionals = {}
        preds, refs = corpora["librispeech"]
        for fn, cls in (("word_error_rate", "WordErrorRate"), ("char_error_rate", "CharErrorRate"),
                        ("match_error_rate", "MatchErrorRate"), ("word_information_lost", "WordInfoLost"),
                        ("word_information_preserved", "WordInfoPreserved")):
            t1 = time.perf_counter()
            value = getattr(ftext, fn)(preds, refs)
            if value.device.type != "cuda" or not np.array_equal(value.cpu().numpy(), card[cls]["value"]):
                raise AssertionError(f"{fn} on the whole set differs from {cls} over updates")
            functionals[fn] = {"ms": (time.perf_counter() - t1) * 1e3, "value": float(value)}
        cpu = {}
        for task, future in futures.items():
            cpu.update(future.result(timeout=600))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    from metrics_tpu_torch.text import ROUGEScore

    modules = {m: importlib.util.find_spec(m) is not None for m in ("nltk", "regex", "sacrebleu")}
    if not modules["nltk"]:
        try:
            ROUGEScore(use_stemmer=True)
        except ModuleNotFoundError as err:
            if str(err) != "Stemmer requires that `nltk` is installed. Use `pip install nltk`.":
                raise
        else:
            raise AssertionError("ROUGEScore(use_stemmer=True) without nltk did not raise")
    fallback, regex_run = card["SacreBLEUScore-intl_fallback"], card["SacreBLEUScore-intl"]
    if any(not np.array_equal(fallback["states"][k], v) for k, v in regex_run["states"].items()):
        raise AssertionError("SacreBLEU intl: the unicodedata fallback's counts differ from the regex rules'")
    record = {}
    for name, run in card.items():
        err = text_compare(np, name, run, cpu[name])
        if not run["device"].startswith("cuda"):
            raise AssertionError(f"{name} ran on {run['device']}")
        value = run["value"]
        record[name] = {"rows": run["rows"], "updates": run["updates"],
                        "host_ms_per_update": run["update_ms_median"], "host_ms_total": run["update_ms_total"],
                        "cpu_host_ms_per_update": cpu[name]["update_ms_median"], "compute_ms": run["compute_ms"],
                        "value": {k: float(v) for k, v in value.items()} if isinstance(value, dict)
                        else [float(np.asarray(v)) for v in value] if isinstance(value, list) else float(value),
                        "max_abs_err_vs_cpu": err, "states_bit_equal": True}
    emit({"phase": "text_strings", "card": smi, "optional_modules": modules, "corpora_s": corpora_s,
          "stemmer_error_checked": not modules["nltk"], "metrics": record, "functionals": functionals})
    return record


def perplexity_inputs(torch, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 67)
    shape = (GPT2["batch"], GPT2["context"], GPT2["vocab"])
    logits = torch.randn(shape, generator=g, device="cuda") * GPT2["scale"]
    target = torch.randint(0, GPT2["vocab"], shape[:2], generator=g, device="cuda")
    boost = torch.full(target.shape + (1,), GPT2["target_boost"], device="cuda")
    logits.scatter_add_(2, target[..., None], boost)
    target[torch.rand(shape[:2], generator=g, device="cuda") < GPT2["ignore_rate"]] = GPT2["ignore_index"]
    return logits, target


def text_perplexity(torch, seed: int, smi: str) -> dict:
    """Perplexity at GPT-2 small's evaluation shape: the card against the port's CPU run
    on the same logits, event and device ms of one update against the bound and one
    ``cross_entropy`` call, and the update as one fused replay."""
    from metrics_tpu_torch.core import MetricCollection
    from metrics_tpu_torch.core.fused import engine_for
    from metrics_tpu_torch.text import Perplexity

    logits, target = perplexity_inputs(torch, seed)
    ignore = GPT2["ignore_index"]
    metric = Perplexity(ignore_index=ignore)
    metric.update(logits, target)
    value = metric.compute()
    t0 = time.perf_counter()
    cpu_metric = Perplexity(ignore_index=ignore, device="cpu")
    cpu_metric.update(logits.cpu(), target.cpu())
    cpu_value, cpu_s = cpu_metric.compute(), time.perf_counter() - t0
    rel = abs(float(value) - float(cpu_value)) / abs(float(cpu_value))
    if not rel <= PPL_REL or int(metric.count) != int(cpu_metric.count):
        raise AssertionError(f"Perplexity on the card {float(value)} against the CPU's {float(cpu_value)}")

    def update():
        metric.update(logits, target)

    ms = event_ms(torch, update, reps=20)
    launches = device_launches(profile_window(torch, update, 10))
    device_ms_ = sum(us for _, us in launches.values()) / 10 / 1e3
    kernels = {k[:70]: {"launches": n / 10, "ms": us / 10 / 1e3} for k, (n, us) in launches.items()}
    library_ms = event_ms(torch, lambda: torch.nn.functional.cross_entropy(
        logits.view(-1, GPT2["vocab"]), target.view(-1), ignore_index=ignore, reduction="sum"), reps=20)
    nbytes = logits.numel() * logits.element_size() + target.numel() * target.element_size()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    eager = Perplexity(ignore_index=ignore)
    fused = MetricCollection({"ppl": Perplexity(ignore_index=ignore)}, fused=True)
    for _ in range(3):
        eager.update(logits, target)
        fused.update(logits, target)
    stats = dict(engine_for(fused).stats)
    if stats["launches"] != 3 or stats["degrades"] or stats["fallback_groups"]:
        raise AssertionError(f"fused Perplexity: stats {stats}")
    fused_value = fused.compute()["ppl"]
    if not torch.equal(fused_value, eager.compute()) or not torch.equal(fused["ppl"].count, eager.count):
        raise AssertionError(f"fused Perplexity {float(fused_value)} differs from eager {float(eager.compute())}")
    fused_ms = event_ms(torch, lambda: fused.update(logits, target), reps=20)
    record = {"shape": list(logits.shape), "dtype": str(logits.dtype).replace("torch.", ""),
              "counted_tokens": int(cpu_metric.count), "value": float(value), "cpu_value": float(cpu_value),
              "rel_err_vs_cpu": rel, "cpu_s": cpu_s, "update_event_ms": ms, "update_device_ms": device_ms_,
              "device_kernels": kernels, "bound_bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
              "share_of_bound": bound_ms / device_ms_ if device_ms_ else None,
              "cross_entropy_sum_ms": library_ms, "fused_update_ms": fused_ms, "fused_stats": stats,
              "fused_equal_to_eager": True}
    emit({"phase": "text_perplexity", "card": smi, **record})
    del logits, target
    return record


def phase_text(torch, seed: int, smi: str) -> dict:
    """The string metrics (host code, states on the card) and Perplexity (plain
    PyTorch on the card). No hand kernel runs here: every launch count must stay 0."""
    t0 = time.perf_counter()
    strings, strings_counted, strings_s = run_counted(torch, lambda: text_strings(torch, seed, smi))
    expect_launches("text strings", strings_counted)
    perplexity, ppl_counted, ppl_s = run_counted(torch, lambda: text_perplexity(torch, seed, smi))
    expect_launches("text perplexity", ppl_counted)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "text", "card": smi, "strings_s": strings_s, "perplexity_s": ppl_s, "seconds": seconds})
    return {"strings": strings, "perplexity": perplexity}


ROBERTA_LARGE = {"vocab": 50_265, "width": 1_024, "layers": 24, "heads": 16, "ffn": 4_096, "positions": 514,
                 "type_vocab": 1, "eps": 1e-5}
BERT_BASE = {"vocab": 30_522, "width": 768, "layers": 12, "heads": 12, "ffn": 3_072, "positions": 512,
             "type_vocab": 2, "eps": 1e-12}
CLIP_L14 = {}  # CLIPModel's defaults: openai/clip-vit-large-patch14's shape
INFOLM_RUN = {"pairs": 64, "max_length": 64, "check_pairs": 2, "check_max_length": 16, "check_words": 10}
COCO_CLIP = {"images": 1_000, "batch": 50, "height": 480, "width": 640, "words": (8, 20), "check_images": 2}
BAPPS = {"pairs": 10_000, "squeeze_pairs": 1_000, "batch": 100, "size": 64, "noise": 0.3, "check_pairs": 4}
MODEL_CHECK_SENTENCES = 4
MODEL_PROFILE_BATCH = 64  # sentences in the profiled BERTScore forward
ENCODER_ATOL = 1e-3  # an encoder's outputs on the card against the port's CPU run, same weights and inputs
BERTSCORE_ATOL = 1e-4  # BERTScore P/R/F1, card against CPU
INFOLM_REL = 1e-4  # InfoLM values, card against CPU, relative to max(|value|, 1): the measures' terms are O(1)
CLIPSCORE_ATOL = 1e-2  # CLIPScore on its 0-100 scale, card against CPU
LPIPS_REL = 1e-4  # LPIPS, card against CPU, relative
LPIPS_IDENTICAL = 1e-6  # LPIPS of a pair of identical images
PREPROCESS_ATOL = 1e-4  # CLIP preprocess on the card against the CPU, normalised units
INFOLM_MEASURES = (("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
                   ("ab_divergence", 0.5, 0.5), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
                   ("l2_distance", None, None), ("l_infinity_distance", None, None),
                   ("fisher_rao_distance", None, None))
MODEL_GROUPS = (  # device time of a forward by kernel family, lower-case substrings, first match wins
    ("matmul_conv", ("gemm", "cutlass", "xmma", "conv", "cudnn", "implicit", "sm90", "sm80", "ampere", "winograd")),
    ("softmax", ("softmax",)),
)


class WordTokenizer:
    """A seeded word-level tokenizer with a HF tokenizer's call: ``[first] words [last]``,
    each word's id a seeded CRC-32 of it in ``[lo, vocab)``; pads to the longest row, or
    to ``max_length`` with ``padding="max_length"``. Stands in for the HF tokenizers,
    which the card's machine does not have."""

    def __init__(self, first: int, last: int, pad: int, lo: int, vocab: int, seed: int, mask: int = -1):
        self.cls_token_id, self.sep_token_id, self.pad_token_id, self.mask_token_id = first, last, pad, mask
        self.lo, self.vocab, self.seed = lo, vocab, seed

    def __call__(self, sentences, padding=True, truncation=True, max_length=512, return_tensors="np"):
        import zlib

        import numpy as np

        rows = [[self.cls_token_id] + [self.lo + zlib.crc32(w.encode(), self.seed) % (self.vocab - self.lo)
                                       for w in s.split()][: max_length - 2] + [self.sep_token_id] for s in sentences]
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, row in enumerate(rows):
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def tokenizer_fn(self, sentences, max_length):
        batch = self(sentences, padding="max_length", max_length=max_length)
        return batch["input_ids"], batch["attention_mask"]

    def special_tokens(self) -> dict:
        return {"pad_token_id": self.pad_token_id, "sep_token_id": self.sep_token_id,
                "cls_token_id": self.cls_token_id, "mask_token_id": self.mask_token_id}


def seeded_transformer_(torch, model, g) -> None:
    """BERT-style initialisation on the model's device: linear, embedding, conv and
    class-token weights N(0, 0.02), biases 0, LayerNorm weights 1 and biases 0."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (torch.nn.Linear, torch.nn.Embedding, torch.nn.Conv2d)):
                module.weight.normal_(0.0, 0.02, generator=g)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
        for name, param in model.named_parameters():
            if name.endswith("cls_emb"):
                param.normal_(0.0, 0.02, generator=g)


def cpu_copy(torch, model_cls, model, **kwargs):
    """``model``'s weights on the CPU, in a model of the same class."""
    return model_cls.from_state({k: v.cpu() for k, v in model.state_dict().items()}, **kwargs, device="cpu")


def forward_split(torch, fn, reps: int = 2) -> dict:
    """Device ms of one ``fn()`` call by MODEL_GROUPS (the rest as ``other``), its busy
    total and its five longest kernels, from a profiler trace."""
    kernels = device_ms(torch, fn, reps=reps)
    split = {group: 0.0 for group, _ in MODEL_GROUPS}
    split["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        split[next((g for g, keys in MODEL_GROUPS if any(k in low for k in keys)), "other")] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": sum(kernels.values()), "split_ms": split, "top": top}


def host_ms(torch, fn):
    """``fn()`` and its host ms up to a synchronised device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rel_err(np, got, want, floor: float = 1e-12) -> float:
    """The largest |got - want| / max(|want|, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))


def to_np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def mm_bertscore(torch, seed: int, wmt14) -> dict:
    """BERTScore over WMT14 newstest2014's 3,003 pairs on roberta-large's shape."""
    from metrics_tpu_torch.functional.text import bert_score
    from metrics_tpu_torch.models.bert import BertEncoder, bert_encoder_from_model
    from metrics_tpu_torch.text import BERTScore

    cfg = ROBERTA_LARGE
    preds, target = wmt14
    tok = WordTokenizer(0, 2, 1, 3, cfg["vocab"], seed + 71)
    g = torch.Generator(device="cuda").manual_seed(seed + 72)
    model = BertEncoder(cfg["vocab"], cfg["width"], cfg["layers"], cfg["ffn"], cfg["positions"], cfg["type_vocab"],
                        cfg["heads"], cfg["eps"], device="cuda")
    seeded_transformer_(torch, model, g)
    encoder = bert_encoder_from_model(model, tok, "roberta")
    record = {"model": "roberta-large shape, seeded N(0, 0.02)", "pairs": len(preds), "config": cfg}
    for idf in (False, True):
        metric = BERTScore(encoder=encoder, idf=idf)
        for i in range(0, len(preds), 64):
            metric.update(preds[i:i + 64], target[i:i + 64])
        out, ms = host_ms(torch, metric.compute)
        f1 = out["f1"]
        if f1.shape != (len(preds),) or not bool(torch.isfinite(f1).all()) or f1.device.type != "cuda":
            raise AssertionError(f"BERTScore(idf={idf}): f1 {f1.shape} on {f1.device}, finite {torch.isfinite(f1).all()}")
        record[f"idf_{idf}"] = {"compute_ms": ms, "sentences_per_s": 2 * len(preds) / ms * 1e3,
                                "f1_mean": float(f1.mean()), "precision_mean": float(out["precision"].mean()),
                                "recall_mean": float(out["recall"].mean())}
    batch = target[:MODEL_PROFILE_BATCH]
    ms = event_ms(torch, lambda: encoder(batch), reps=5, warmup=2)
    record["forward_64"] = {"event_ms": ms, "sentences_per_s": len(batch) / ms * 1e3,
                            **forward_split(torch, lambda: encoder(batch))}

    # the card against the port's CPU run on the same weights
    cpu_model = cpu_copy(torch, BertEncoder, model, num_heads=cfg["heads"], eps=cfg["eps"])
    cpu_encoder = bert_encoder_from_model(cpu_model, tok, "roberta")
    sub_p, sub_t = preds[:MODEL_CHECK_SENTENCES], target[:MODEL_CHECK_SENTENCES]
    hidden_err = float((encoder(sub_t)[0].cpu() - cpu_encoder(sub_t)[0]).abs().max())
    if not hidden_err <= ENCODER_ATOL:
        raise AssertionError(f"roberta-large hidden states: card vs CPU {hidden_err} > {ENCODER_ATOL}")
    score_err = 0.0
    for idf in (False, True):
        card = bert_score(sub_p, sub_t, encoder, idf=idf)
        cpu = bert_score(sub_p, sub_t, cpu_encoder, idf=idf, device="cpu")
        score_err = max(score_err, *(float((card[k].cpu() - cpu[k]).abs().max()) for k in ("precision", "recall", "f1")))
    if not score_err <= BERTSCORE_ATOL:
        raise AssertionError(f"BERTScore card vs CPU {score_err} > {BERTSCORE_ATOL}")
    record.update({"hidden_max_abs_err_vs_cpu": hidden_err, "score_max_abs_err_vs_cpu": score_err})
    del model, cpu_model
    return record


def mm_infolm(torch, seed: int, wmt14) -> dict:
    """InfoLM's nine measures over 64 WMT14 pairs at max_length 64 on bert-base-uncased's
    shape with its MLM head."""
    import numpy as np

    from metrics_tpu_torch.functional.text import infolm
    from metrics_tpu_torch.functional.text.helper import _input_ids_idf, _tokens_idf
    from metrics_tpu_torch.functional.text.infolm import _InformationMeasure, masked_lm_distribution
    from metrics_tpu_torch.models.bert import BertEncoder, mlm_logits_fn_from_model
    from metrics_tpu_torch.text import InfoLM

    cfg, run = BERT_BASE, INFOLM_RUN
    preds, target = wmt14
    tok = WordTokenizer(101, 102, 0, 1_000, cfg["vocab"], seed + 73, mask=103)
    g = torch.Generator(device="cuda").manual_seed(seed + 74)
    model = BertEncoder(cfg["vocab"], cfg["width"], cfg["layers"], cfg["ffn"], cfg["positions"], cfg["type_vocab"],
                        cfg["heads"], cfg["eps"], mlm_head=True, device="cuda")
    seeded_transformer_(torch, model, g)
    logits_fn = mlm_logits_fn_from_model(model, "bert")
    kwargs = {"max_length": run["max_length"], "logits_fn": logits_fn, "tokenizer_fn": tok.tokenizer_fn,
              "special_tokens_map": tok.special_tokens()}
    record = {"model": "bert-base-uncased shape with MLM head, seeded N(0, 0.02)", "pairs": run["pairs"],
              "max_length": run["max_length"], "forwards_per_compute": 2 * run["max_length"], "measures": {}}
    for measure, alpha, beta in INFOLM_MEASURES:
        metric = InfoLM(information_measure=measure, alpha=alpha, beta=beta, **kwargs)
        metric.update(preds[: run["pairs"]], target[: run["pairs"]])
        value, ms = host_ms(torch, metric.compute)
        if value.device.type != "cuda" or not bool(torch.isfinite(value)):
            raise AssertionError(f"InfoLM {measure}: {value} on {value.device}")
        record["measures"][measure] = {"value": float(value), "compute_ms": ms}
    ids, mask = tok.tokenizer_fn(target[: run["pairs"]], run["max_length"])
    forward = lambda: logits_fn(ids, mask)  # noqa: E731
    ms = event_ms(torch, forward, reps=5, warmup=2)
    record["forward_64x64"] = {"event_ms": ms, "sentences_per_s": len(ids) / ms * 1e3,
                               **forward_split(torch, forward)}

    # the card against the port's CPU run: short pairs, the distributions, the nine
    # measures on them and one functional call
    cpu_fn = mlm_logits_fn_from_model(cpu_copy(torch, BertEncoder, model, num_heads=cfg["heads"], eps=cfg["eps"]), "bert")
    short = [i for i in range(len(preds)) if max(len(preds[i].split()), len(target[i].split())) <= run["check_words"]]
    sub_p, sub_t = [preds[i] for i in short[: run["check_pairs"]]], [target[i] for i in short[: run["check_pairs"]]]
    special, length = tok.special_tokens(), run["check_max_length"]
    t_ids, t_mask = tok.tokenizer_fn(sub_t, length)
    p_ids, p_mask = tok.tokenizer_fn(sub_p, length)
    idf_map = _tokens_idf(t_ids)
    dists = {}
    for side, fn, device in (("card", logits_fn, "cuda"), ("cpu", cpu_fn, "cpu")):
        dists[side] = [masked_lm_distribution(i, m, fn, special, 0.25, _input_ids_idf(i, idf_map), device).cpu()
                       for i, m in ((p_ids, p_mask), (t_ids, t_mask))]
    dist_err = max(float((a - b).abs().max()) for a, b in zip(dists["card"], dists["cpu"]))
    measure_err = {}
    for measure, alpha, beta in INFOLM_MEASURES:
        card = _InformationMeasure(measure, alpha, beta)(*dists["card"])
        cpu = _InformationMeasure(measure, alpha, beta)(*dists["cpu"])
        if measure == "fisher_rao_distance":  # compared as cos(d / 2): arccos is ill-conditioned at d = 0
            card, cpu = torch.cos(card / 2), torch.cos(cpu / 2)
        measure_err[measure] = rel_err(np, card, cpu, 1.0)
    functional = [infolm(sub_p, sub_t, max_length=length, logits_fn=fn, tokenizer_fn=tok.tokenizer_fn,
                         special_tokens_map=special, device=device, return_sentence_level_score=True)
                  for fn, device in ((logits_fn, "cuda"), (cpu_fn, "cpu"))]
    functional_err = max(rel_err(np, to_np(a), to_np(b), 1.0) for a, b in zip(*functional))
    worst = max(max(measure_err.values()), functional_err)
    if not (dist_err <= 1e-5 and worst <= INFOLM_REL):
        raise AssertionError(f"InfoLM card vs CPU: distributions {dist_err}, measures {measure_err}, "
                             f"functional {functional_err}")
    record.update({"distribution_max_abs_err_vs_cpu": dist_err, "measure_max_rel_err_vs_cpu": measure_err,
                   "functional_max_rel_err_vs_cpu": functional_err})
    del model
    return record


def coco_captions(seed: int, n: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed + 75)
    vocab = text_vocab(rng, LIBRISPEECH["vocab"])
    lo, hi = COCO_CLIP["words"]
    return [" ".join(vocab[i] for i in rng.integers(0, len(vocab), rng.integers(lo, hi + 1))) for _ in range(n)]


def mm_clipscore(torch, seed: int) -> dict:
    """CLIPScore over 1,000 uint8 480x640 images with one caption each, in updates of 50,
    on openai/clip-vit-large-patch14's shape."""
    from metrics_tpu_torch.functional.multimodal import clip_score
    from metrics_tpu_torch.models.clip import CLIPModel, clip_encoders_from_model, preprocess
    from metrics_tpu_torch.multimodal import CLIPScore

    run = COCO_CLIP
    g = torch.Generator(device="cuda").manual_seed(seed + 76)
    model = CLIPModel(**CLIP_L14, device="cuda")
    seeded_transformer_(torch, model, g)
    tok = WordTokenizer(49406, 49407, 49407, 1, 49406, seed + 77)
    image_encoder, text_encoder = clip_encoders_from_model(model, tok)
    captions = coco_captions(seed, run["images"])
    shape = (run["batch"], 3, run["height"], run["width"])
    metric = CLIPScore(image_encoder=image_encoder, text_encoder=text_encoder)
    update_ms = []
    for i in range(0, run["images"], run["batch"]):
        images = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
        if i == 0:
            check = images[: run["check_images"]].clone()
            first = images
        _, ms = host_ms(torch, lambda: metric.update(images, captions[i:i + run["batch"]]))
        update_ms.append(ms)
    value, compute_ms = host_ms(torch, metric.compute)
    if int(metric.n_samples) != run["images"] or metric.n_samples.dtype != torch.int64:
        raise AssertionError(f"CLIPScore n_samples {metric.n_samples}")
    if not (0.0 <= float(value) <= 100.0) or value.device.type != "cuda":
        raise AssertionError(f"CLIPScore {value} on {value.device}")
    batch_captions = captions[: run["batch"]]
    record = {"model": "openai/clip-vit-large-patch14 shape, seeded N(0, 0.02)", "images": run["images"],
              "image_shape": list(shape[1:]), "batch": run["batch"], "value": float(value),
              "update_ms_median": statistics.median(update_ms), "update_ms_total": sum(update_ms),
              "compute_ms": compute_ms,
              "preprocess_ms": event_ms(torch, lambda: preprocess(first), reps=5, warmup=1)}
    image_ms = event_ms(torch, lambda: image_encoder(first), reps=3, warmup=1)
    text_ms = event_ms(torch, lambda: text_encoder(batch_captions), reps=5, warmup=1)
    record["image_forward_50"] = {"event_ms": image_ms, "images_per_s": run["batch"] / image_ms * 1e3,
                                  **forward_split(torch, lambda: image_encoder(first))}
    record["text_forward_50"] = {"event_ms": text_ms, "captions_per_s": run["batch"] / text_ms * 1e3,
                                 **forward_split(torch, lambda: text_encoder(batch_captions))}

    cpu_model = cpu_copy(torch, CLIPModel, model)
    cpu_image, cpu_text = clip_encoders_from_model(cpu_model, tok)
    check_cpu, sub = check.cpu(), captions[: run["check_images"]]
    pre_err = float((preprocess(check).cpu() - preprocess(check_cpu)).abs().max())
    image_err = float((image_encoder(check).cpu() - cpu_image(check_cpu)).abs().max())
    text_err = float((text_encoder(sub).cpu() - cpu_text(sub)).abs().max())
    score_err = abs(float(clip_score(check, sub, image_encoder=image_encoder, text_encoder=text_encoder))
                    - float(clip_score(check_cpu, sub, image_encoder=cpu_image, text_encoder=cpu_text)))
    if not (pre_err <= PREPROCESS_ATOL and max(image_err, text_err) <= ENCODER_ATOL and score_err <= CLIPSCORE_ATOL):
        raise AssertionError(f"CLIP card vs CPU: preprocess {pre_err}, image {image_err}, text {text_err}, "
                             f"score {score_err}")
    record.update({"preprocess_max_abs_err_vs_cpu": pre_err, "image_features_max_abs_err_vs_cpu": image_err,
                   "text_features_max_abs_err_vs_cpu": text_err, "score_abs_err_vs_cpu": score_err})
    del model, cpu_model
    return record


def lpips_files(torch, net_type: str, g, root: str) -> dict:
    """Seeded weights of one LPIPS network drawn on the card and written where the
    metric's entry point reads them: He-scaled convs (activations stay O(1) through
    VGG16's 13 convs), zero biases, lin heads |N(0, 1)| / C."""
    import numpy as np

    from metrics_tpu_torch.models.lpips import LPIPS_CHANNELS, backbone_shapes

    backbone = {}
    for key, shape in backbone_shapes(net_type).items():
        if key.endswith("weight"):
            fan_in = shape[1] * shape[2] * shape[3]
            w = torch.empty(shape, device="cuda").normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)
        else:
            w = torch.zeros(shape, device="cuda")
        backbone[key] = w.cpu().numpy()
    lins = {f"lin{i}.model.1.weight": (torch.empty((1, c, 1, 1), device="cuda").normal_(generator=g).abs() / c)
            .cpu().numpy() for i, c in enumerate(LPIPS_CHANNELS[net_type])}
    paths = {"backbone_weights": os.path.join(root, f"lpips_{net_type}.npz"),
             "linear_weights": os.path.join(root, f"lpips_{net_type}_lin.npz")}
    np.savez(paths["backbone_weights"], **backbone)
    np.savez(paths["linear_weights"], **lins)
    return paths


def mm_lpips(torch, seed: int) -> dict:
    """LPIPS on BAPPS-sized 64x64 patch pairs: AlexNet and VGG16 on 10,000, SqueezeNet
    on 1,000, in updates of 100. The seeded weights go through files in a temporary
    directory under ``build/``, as the metric reads them."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="lpips_", dir=build) as root:
        return lpips_runs(torch, seed, root)


def lpips_runs(torch, seed: int, root: str) -> dict:
    from metrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity as LPIPS
    from metrics_tpu_torch.models.lpips import load_lpips

    run = BAPPS
    g = torch.Generator(device="cuda").manual_seed(seed + 78)
    shape = (run["batch"], 3, run["size"], run["size"])
    record = {}
    for net_type in ("alex", "vgg", "squeeze"):
        files = lpips_files(torch, net_type, g, root)
        metric = LPIPS(net_type=net_type, **files)
        pairs = run["squeeze_pairs"] if net_type == "squeeze" else run["pairs"]
        update_ms = []
        for i in range(pairs // run["batch"]):
            img1 = torch.rand(shape, generator=g, device="cuda") * 2 - 1
            img2 = torch.clamp(img1 + run["noise"] * torch.randn(shape, generator=g, device="cuda"), -1, 1)
            if i == 0:
                first = (img1, img2)
            _, ms = host_ms(torch, lambda: metric.update(img1, img2))
            update_ms.append(ms)
        value, compute_ms = host_ms(torch, metric.compute)
        if int(metric.total) != pairs or metric.total.dtype != torch.int64 or not bool(torch.isfinite(value)):
            raise AssertionError(f"LPIPS {net_type}: total {metric.total}, value {value}")
        network = load_lpips(net_type, **files, device="cuda")
        identical = float(network(first[0], first[0]).abs().max())
        if not identical < LPIPS_IDENTICAL:
            raise AssertionError(f"LPIPS {net_type} of identical images: {identical}")
        k = min(run["check_pairs"], run["batch"])
        card = LPIPS(net_type=net_type, **files)
        cpu = LPIPS(net_type=net_type, **files, device="cpu")
        card.update(first[0][:k], first[1][:k])
        cpu.update(first[0][:k].cpu(), first[1][:k].cpu())
        err = abs(float(card.compute()) - float(cpu.compute())) / abs(float(cpu.compute()))
        if not err <= LPIPS_REL or int(card.total) != k or int(cpu.total) != k:
            raise AssertionError(f"LPIPS {net_type} card vs CPU: {err}")
        pair_ms = event_ms(torch, lambda: network(*first), reps=5, warmup=1)
        record[net_type] = {"pairs": pairs, "value": float(value), "update_ms_median": statistics.median(update_ms),
                            "update_ms_total": sum(update_ms), "compute_ms": compute_ms,
                            "forward_100_pairs": {"event_ms": pair_ms, "pairs_per_s": run["batch"] / pair_ms * 1e3,
                                                  **forward_split(torch, lambda: network(*first))},
                            "identical_pair": identical, "rel_err_vs_cpu": err}
    return record


def phase_model_metrics(torch, seed: int, smi: str) -> dict:
    """BERTScore, InfoLM, CLIPScore and LPIPS at published widths with seeded weights, no
    hand kernel (every launch count 0), each held against the port's CPU run."""
    t0 = time.perf_counter()
    preds, refs = text_corpora(seed)["wmt14"]
    wmt14 = (preds, [r[0] for r in refs])
    record = {}
    for name, fn in (("bertscore", lambda: mm_bertscore(torch, seed, wmt14)),
                     ("infolm", lambda: mm_infolm(torch, seed, wmt14)), ("clipscore", lambda: mm_clipscore(torch, seed)),
                     ("lpips", lambda: mm_lpips(torch, seed))):
        torch.cuda.reset_peak_memory_stats()
        out, counted, seconds = run_counted(torch, fn)
        expect_launches(f"model metrics {name}", counted)
        out.update({"seconds": seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        emit({"phase": f"model_metrics_{name}", "card": smi, **out})
        record[name] = out
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "model_metrics", "card": smi, "seconds": seconds,
          "parts_s": {name: r["seconds"] for name, r in record.items()}})
    return record


# ------------------------------------------------------------------ ckpt_ingest

CKPT_INGEST = {"dlrm_capacity": 1 << 27, "save_after": 680, "stall_window": 40, "fused_steps": 200,
               "fused_rows": 65_536, "fused_save_at": 100, "enqueues": 200, "fault_steps": 50,
               "fault_rate": 0.25, "fault_seed": 7, "tick_fault_batches": 20}


def ck_dir(name: str) -> str:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ckpt_ingest", name)
    shutil.rmtree(root, ignore_errors=True)
    return root


def dlrm_collection(capacity: int):
    from metrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision
    from metrics_tpu_torch.core import MetricCollection

    return MetricCollection({"auroc": BinaryAUROC(cat_capacity=capacity),
                             "auroc_max_fpr": BinaryAUROC(max_fpr=0.1, cat_capacity=capacity),
                             "ap": BinaryAveragePrecision(cat_capacity=capacity)})


def same_values(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and bool((a[k] == b[k]).all()) for k in a)


def synced_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def ci_dlrm(torch, seed: int, smi: str) -> dict:
    """The DLRM collection saved asynchronously mid-stream, restored and finished."""
    cfg = CKPT_INGEST
    torch.cuda.reset_peak_memory_stats()
    scores, target = dlrm_data(torch, seed)
    batches = dlrm_batches(scores, target, DLRM["samples"])
    half = cfg["save_after"]
    directory = ck_dir("dlrm")
    whole = dlrm_collection(cfg["dlrm_capacity"])
    before, during = [], []
    for i, (p, t) in enumerate(batches[:half]):
        if i < half - cfg["stall_window"]:
            whole.update(p, t)
        else:  # the updates just before the save, each timed alone
            before.append(synced_ms(torch, lambda: whole.update(p, t)))
    t_call = time.perf_counter()
    handle = whole.save_checkpoint(directory, blocking=False)
    call_ms = (time.perf_counter() - t_call) * 1e3
    commit_seen_s = None
    for p, t in batches[half:]:
        if not handle.done():
            during.append(synced_ms(torch, lambda: whole.update(p, t)))
            if handle.done():
                commit_seen_s = time.perf_counter() - t_call
        else:
            whole.update(p, t)
    handle.result()
    if commit_seen_s is None:
        commit_seen_s = time.perf_counter() - t_call
    if not handle.committed:
        raise AssertionError("the DLRM checkpoint did not commit")
    stats = dict(whole._ckpt_stats)
    resumed = dlrm_collection(cfg["dlrm_capacity"])
    restore_ms = synced_ms(torch, lambda: resumed.restore_checkpoint(directory))
    for p, t in batches[half:]:
        resumed.update(p, t)
    want, l_whole, _ = run_counted(torch, whole.compute)
    got, l_resumed, _ = run_counted(torch, resumed.compute)
    expect_launches("DLRM computes, uninterrupted", l_whole, scan=3)
    expect_launches("DLRM computes, restored", l_resumed, scan=3)
    if not same_values(got, want):
        raise AssertionError(f"restored DLRM computes {got} != uninterrupted {want}")
    record = {"rows": DLRM["samples"], "updates": len(batches), "saved_after_update": half,
              "capacity": cfg["dlrm_capacity"], "bit_equal": True, "values": {k: float(v) for k, v in got.items()},
              "save_call_host_ms": call_ms, "bytes": stats["last_save_bytes"],
              "writer_ms_to_commit": stats["last_save_ms"], "commit_seen_s": commit_seen_s,
              "update_ms_before_median": statistics.median(before),
              "update_ms_during_median": statistics.median(during) if during else None,
              "updates_during_write": len(during), "restore_ms": restore_ms,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": {"segment_scan": l_whole["segment_scan"] + l_resumed["segment_scan"]}}
    emit({"phase": "ckpt_ingest_dlrm", "card": smi, **record})
    shutil.rmtree(os.path.dirname(directory), ignore_errors=True)
    return record


def canonical_batches(torch, seed: int):
    cfg = CKPT_INGEST
    g = torch.Generator(device="cuda").manual_seed(seed + 21)
    n, steps = cfg["fused_rows"], cfg["fused_steps"]
    preds = torch.rand((steps, n), generator=g, device="cuda")
    target = torch.randint(0, 2, (steps, n), generator=g, device="cuda", dtype=torch.int32)
    return preds, target


def ci_fused(torch, preds, target, smi: str) -> dict:
    """Blocking save of a fused collection at step 100, restored into a stepped one."""
    from metrics_tpu_torch.core.fused import canonical_collection, engine_for

    cfg = CKPT_INGEST
    steps, at = cfg["fused_steps"], cfg["fused_save_at"]
    directory = ck_dir("fused")
    eager = canonical_collection(False)
    _, eager_launches, _ = run_counted(torch, lambda: [eager.update(preds[i], target[i]) for i in range(4)])
    per_step = eager_launches["histogram"] // 4
    whole = canonical_collection(True)
    _, l_first, _ = run_counted(torch, lambda: [whole.update(preds[i], target[i]) for i in range(at)])
    t0 = time.perf_counter()
    whole.save_checkpoint(directory)
    save_ms = (time.perf_counter() - t0) * 1e3
    _, l_rest, _ = run_counted(torch, lambda: [whole.update(preds[i], target[i]) for i in range(at, steps)])
    resumed = canonical_collection(True)
    _, l_warm, _ = run_counted(torch, lambda: resumed.update(preds[steps - 1], target[steps - 1]))
    restore_ms = synced_ms(torch, lambda: resumed.restore_checkpoint(directory))
    _, l_resumed, _ = run_counted(torch, lambda: [resumed.update(preds[i], target[i]) for i in range(at, steps)])
    got, want = resumed.compute(), whole.compute()
    if not same_values(got, want):
        raise AssertionError("the restored fused collection differs from the uninterrupted run")
    stats = dict(engine_for(resumed).stats)
    if stats["degrades"] or stats["launches"] != steps - at + 1 or stats["cache_misses"] != 1:
        raise AssertionError(f"restored fused collection stats {stats}")
    expect_launches("fused steps after the restore", l_resumed, histogram=per_step * (steps - at))
    expect_launches("fused steps before the save", l_first, histogram=per_step * (at + 1))
    record = {"steps": steps, "saved_at": at, "rows": cfg["fused_rows"], "bit_equal": True,
              "histogram_per_replay": per_step, "save_ms": save_ms, "restore_ms": restore_ms,
              "bytes": whole._ckpt_stats["last_save_bytes"], "stats": stats}
    emit({"phase": "ckpt_ingest_fused", "card": smi, **record})
    launches = {k: l_first[k] + l_rest[k] + l_warm[k] + l_resumed[k] + eager_launches[k] for k in l_first}
    return {"record": record, "want": want, "launches": launches, "per_step": per_step}


def ci_ingest(torch, preds, target, want: dict, per_step: int, smi: str) -> dict:
    """A producer thread enqueueing the 200 batches against the tick thread."""
    import threading

    from metrics_tpu_torch.core.fused import CapturedStep, canonical_collection
    from metrics_tpu_torch.serve import IngestQueue

    cfg = CKPT_INGEST
    n = cfg["enqueues"]
    # the enqueues alone, with no tick thread beside them (a manual queue, flushed after)
    manual_coll = canonical_collection(True)
    idle_us = []
    with IngestQueue(manual_coll, capacity=256, start=False) as manual:
        for i in range(n):
            s = time.perf_counter()
            manual.enqueue(preds[i], target[i])
            idle_us.append((time.perf_counter() - s) * 1e6)
        _, manual_launches, manual_s = run_counted(torch, manual.flush)
        manual_stats = dict(manual.stats)
    if not same_values(manual_coll.compute(), want) or manual_stats["degrades"]:
        raise AssertionError(f"the manually flushed queue differs from the synchronous run: {manual_stats}")
    target_coll = canonical_collection(True)
    enqueue_us, errors = [], []
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with IngestQueue(target_coll, capacity=256) as queue:

        def produce():
            try:
                for i in range(n):
                    s = time.perf_counter()
                    queue.enqueue(preds[i], target[i])
                    enqueue_us.append((time.perf_counter() - s) * 1e6)
            except BaseException as err:  # noqa: BLE001
                errors.append(err)

        producer = threading.Thread(target=produce, name="smoke-producer")
        producer.start()
        producer.join(timeout=300)
        if producer.is_alive() or errors:
            raise AssertionError(f"the producer failed: {errors}")
        queue.flush()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats, step_stats = dict(queue.stats), dict(queue.step_stats)
        captured = all(isinstance(s, CapturedStep) for s in queue._steps.steps.values())
    launches = all_launches()
    got = target_coll.compute()
    if not same_values(got, want):
        raise AssertionError("the ticked collection differs from the synchronous fused run")
    if stats["degrades"] or step_stats["degrades"] or stats["eager_entries"] or not captured:
        raise AssertionError(f"ingest fell back: stats {stats}, step stats {step_stats}, captured {captured}")
    expected = per_step * (n + stats["capture_entries"])
    if launches["histogram"] != expected or stats["launches"] != stats["ticks"]:
        raise AssertionError(f"ingest launches {launches}, expected {expected} histogram; stats {stats}")
    ordered = sorted(enqueue_us)
    record = {"enqueues": n, "rows": n * cfg["fused_rows"], "bit_equal": True, "stats": stats,
              "step_stats": step_stats, "replays_per_tick": stats["launches"] / stats["ticks"],
              "enqueue_us_median": statistics.median(ordered),
              "enqueue_us_p99": ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))],
              "rows_per_s": n * cfg["fused_rows"] / seconds, "seconds": seconds,
              "histogram_launches": launches["histogram"], "histogram_expected": expected,
              "no_ticker": {"enqueue_us_median": statistics.median(idle_us), "flush_s": manual_s,
                            "ticks": manual_stats["ticks"], "capture_entries": manual_stats["capture_entries"]}}
    emit({"phase": "ckpt_ingest_queue", "card": smi, **record})
    return {"record": record, "launches": {k: launches[k] + manual_launches[k] for k in launches}}


def ci_faults(torch, preds, target, seed: int, smi: str) -> dict:
    import warnings

    from metrics_tpu_torch import fault
    from metrics_tpu_torch.classification import MulticlassJaccardIndex
    from metrics_tpu_torch.core.fused import canonical_collection, engine_for
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.serve import IngestQueue

    cfg = CKPT_INGEST
    totals = {}

    def counted(fn):
        out, launches, _ = run_counted(torch, fn)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        return out

    # fused.launch at rate 0.25 over 50 steps
    fused, eager = canonical_collection(True), canonical_collection(False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fault.FaultSchedule(seed=cfg["fault_seed"], sites=("fused.launch",), rate=cfg["fault_rate"]) as sched:
            counted(lambda: [(fused.update(preds[i], target[i]), eager.update(preds[i], target[i]))
                             for i in range(cfg["fault_steps"])])
    degrades = engine_for(fused).stats["degrades"]
    if not same_values(fused.compute(), eager.compute()) or degrades < 1 or not sched.fired:
        raise AssertionError(f"fused.launch schedule: degrades {degrades}, fired {sched.fired}")
    # one ingest.tick fault: the tick's batches go through the public update
    k = cfg["tick_fault_batches"]
    sync = canonical_collection(True)
    counted(lambda: [sync.update(preds[i], target[i]) for i in range(k)])
    ticked = canonical_collection(True)
    with IngestQueue(ticked, capacity=64, start=False) as queue:
        for i in range(k):
            queue.enqueue(preds[i], target[i])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fault.FaultSchedule(fire_at={"ingest.tick": 0}):
                counted(queue.flush)
        tick_stats = dict(queue.stats)
    if (tick_stats["degrades"], tick_stats["coalesced_rows"], ticked["BinaryAccuracy"]._update_count) != (
            1, k * cfg["fused_rows"], k) or not same_values(ticked.compute(), sync.compute()):
        raise AssertionError(f"ingest.tick fault: stats {tick_stats}")
    # ckpt.fsync at occurrence 0: the retry commits
    directory = ck_dir("fsync")
    m = MeanSquaredError()
    m.update(preds[0], target[0].float())
    with fault.FaultSchedule(fire_at={"ckpt.fsync": 0}) as fsync_sched:
        handle = m.save_checkpoint(directory, retry_backoff_s=0.001)
    back = MeanSquaredError()
    back.restore_checkpoint(directory)
    if not handle.committed or [e["site"] for e in fsync_sched.fired] != ["ckpt.fsync"] or not bool(
            back.compute() == m.compute()):
        raise AssertionError("ckpt.fsync fault: the retry did not commit the same state")
    # a poisoned Cityscapes batch under nan_policy="raise"
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    jaccard = MulticlassJaccardIndex(num_classes=CITYSCAPES["classes"], ignore_index=CITYSCAPES["ignore_index"],
                                     nan_policy="raise")
    logits, labels = cityscapes_batch(torch, g)
    counted(lambda: jaccard.update(logits, labels))
    before = {name: v.clone() for name, v in jaccard.metric_state.items()}
    logits, labels = cityscapes_batch(torch, g)
    rejected = None
    with fault.FaultSchedule(seed=seed, fire_at={"input.poison": 0}) as poison_sched:
        try:
            counted(lambda: jaccard.update(logits, labels))
        except fault.PoisonedInputError as err:
            rejected = err.rows
    del logits, labels
    untouched = all(torch.equal(v, before[name]) for name, v in jaccard.metric_state.items())
    if rejected is None or not untouched or jaccard._update_count != 1:
        raise AssertionError(f"poisoned batch: rejected rows {rejected}, state untouched {untouched}")
    shutil.rmtree(os.path.dirname(directory), ignore_errors=True)
    record = {"fused_launch": {"steps": cfg["fault_steps"], "rate": cfg["fault_rate"], "seed": cfg["fault_seed"],
                               "fired": len(sched.fired), "degrades": degrades, "bit_equal": True},
              "ingest_tick": {"batches": k, "degrades": tick_stats["degrades"], "rows": tick_stats["coalesced_rows"],
                              "bit_equal": True},
              "ckpt_fsync": {"fired": len(fsync_sched.fired), "committed": True},
              "input_poison": {"poisoned_rows": poison_sched.fired[0]["rows"], "rejected_rows": rejected,
                               "state_untouched": True}}
    emit({"phase": "ckpt_ingest_faults", "card": smi, **record})
    return {"record": record, "launches": totals}


def phase_ckpt_ingest(torch, seed: int, smi: str) -> dict:
    """Checkpoints, the ingest queue and fault injection; returns the phase's launches
    of each kernel."""
    t0 = time.perf_counter()
    dlrm = ci_dlrm(torch, seed, smi)
    torch.cuda.empty_cache()
    preds, target = canonical_batches(torch, seed)
    fused = ci_fused(torch, preds, target, smi)
    ingest = ci_ingest(torch, preds, target, fused["want"], fused["per_step"], smi)
    faults = ci_faults(torch, preds, target, seed, smi)
    launches = {name: sum(part["launches"].get(name, 0) for part in (fused, ingest, faults))
                for name in KERNEL_WRAPPERS}
    launches["segment_scan"] += dlrm["launches"]["segment_scan"]
    emit({"phase": "ckpt_ingest", "card": smi, "seconds": time.perf_counter() - t0, "launches": launches})
    return launches


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

    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    smi = phase_device(torch)
    phase_build()
    mark("build")
    phase_kernel_vs_plain(torch, args.seed)
    phase_segscan_kernel_vs_plain(torch, args.seed)
    mark("kernel_checks")
    gpu, batch, launches = phase_main_path(torch, args.seed)
    curve = phase_curve_path(torch, args.seed)
    mark("main_and_curve_paths")
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
    mark("timing_and_retrieval")

    batches, collection_values, collection_launches = phase_collection(torch, args.seed, smi)
    nccl = phase_sync_nccl(torch, args.seed, batches, collection_values, map_value, smi)
    del batches
    ranks = phase_sync_ranks(torch, args.seed, smi)
    mark("collection_and_syncs")
    kernels[0]["launches"] += collection_launches + nccl["histogram"] + ranks["histogram"]
    scan["launches"] += nccl["segment_scan"] + ranks["segment_scan"]
    rest = phase_classification_rest(torch, args.seed, smi)
    mark("classification_rest")
    kernels[0]["launches"] += rest["histogram"]
    scan["launches"] += rest["segment_scan"]
    phase_image(torch, args.seed, smi)
    mark("image")
    torch.cuda.empty_cache()
    match, detection_histogram = phase_detection(torch, args.seed, smi)
    mark("detection")
    kernels[0]["launches"] += detection_histogram
    kernels.append(match)
    torch.cuda.empty_cache()
    regression_audio, kendall = phase_regression_audio(torch, args.seed, smi)
    mark("regression_audio")
    scan["launches"] += regression_audio["segment_scan"]
    kernels.append(kendall)
    torch.cuda.empty_cache()
    wrappers_nominal = phase_wrappers_nominal(torch, args.seed, smi)
    mark("wrappers_nominal")
    kernels[0]["launches"] += wrappers_nominal["histogram"]
    scan["launches"] += wrappers_nominal["segment_scan"]
    torch.cuda.empty_cache()
    batched, fused_histogram = phase_engines(torch, args.seed, smi)
    mark("engines")
    kernels[0]["launches"] += fused_histogram
    kernels.insert(1, batched)
    torch.cuda.empty_cache()
    stacked = phase_wrappers_stacked(torch, args.seed, smi)
    mark("wrappers_stacked")
    kernels[0]["launches"] += stacked["histogram"]
    batched["launches"] += stacked["histogram_batched"]
    scan["launches"] += stacked["segment_scan"]
    torch.cuda.empty_cache()
    sketches = phase_sketches(torch, args.seed, smi)
    mark("sketches")
    kernels[0]["launches"] += sketches["histogram"]
    batched["launches"] += sketches["histogram_batched"]
    scan["launches"] += sketches["segment_scan"]
    torch.cuda.empty_cache()
    phase_text(torch, args.seed, smi)
    mark("text")
    torch.cuda.empty_cache()
    phase_model_metrics(torch, args.seed, smi)
    mark("model_metrics")
    torch.cuda.empty_cache()
    ckpt_ingest = phase_ckpt_ingest(torch, args.seed, smi)
    mark("ckpt_ingest")
    kernels[0]["launches"] += ckpt_ingest["histogram"]
    scan["launches"] += ckpt_ingest["segment_scan"]

    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    emit({"phase": "seconds_per_phase", "card": smi, "total_s": marks[-1][1] - marks[0][1],
          "seconds": {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
