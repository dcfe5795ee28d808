"""metrics_tpu_torch stands alone: no JAX, nothing of metrics_tpu, CUDA by default.

- importing the package (and every module of it) in a fresh interpreter loads
  neither ``jax`` nor any ``metrics_tpu`` module, the root exports and the rest of
  classification (fixed points, calibration, hinge, ranking, fairness, Dice) included;
- no file of the package, nor ``chip_smoke.py``, the ``scripts/torch_*.py``
  profilers, the rank side of the sync tests (``tests/torch_sync_ranks.py``) and the
  image slice's checks on the card (``tests/test_torch_image_card.py``),
  imports them (AST scan); both checks cover the runtime core for many ranks
  (``parallel/``, ``core/collections.py``, ``core/aggregation.py``) and the
  stat-scores classes added with it;
- a ``Metric`` built without ``device=`` raises where CUDA is absent (every
  aggregator and stat-scores class too, and so a ``MetricCollection`` of them), and
  so does a functional entry point given a numpy input;
- the kernel modules import, and a CPU run goes by the plain versions, without
  ``nvcc``: the launch counts stay 0 (the confusion path, the curves, calibration,
  fairness and the fixed points);
- the image and pairwise slice (``image/``, ``functional/image/``,
  ``functional/pairwise/``, ``models/``) is in both scans, and its classes, its
  functionals given numpy inputs and the InceptionV3 raise without a card unless
  given ``device=``;
- the detection slice (``detection/``, ``functional/detection/``,
  ``ops/greedy_match.py``, the rank side of its sync test and its checks on the card)
  is in both scans; its classes and its functionals given numpy inputs raise without
  a card unless given ``device=``, and a CPU mAP compute, in both layouts, leaves the
  greedy-match launch count at 0 without ``nvcc``;
- the regression and audio slice (``regression/``, ``functional/regression/``,
  ``audio/``, ``functional/audio/``, ``ops/kendall.py``, ``utils/imports.py``) is in
  both scans; its classes and its functionals given numpy inputs raise without a card
  unless given ``device=``, and a CPU Spearman and Kendall compute leaves every
  kernel's launch count at 0 without ``nvcc``;
- the text slice (``text/``, ``functional/text/``) is in both scans; a fresh import of
  every module loads neither ``nltk`` nor ``transformers``, ``tokenizers`` or
  ``sacrebleu``; its classes, and its functionals given strings (Perplexity's given
  numpy logits), raise without a card unless given ``device=``;
- checkpoints, fault injection and the ingest queue (``ckpt/``, ``fault/``, ``serve/``,
  ``obs/``, ``utils/concurrency.py``) are in both scans, and an ``IngestQueue`` over a
  metric built without ``device=`` raises where CUDA is absent;
- the metrics server (``serve/server.py``, ``serve/excache.py``, ``serve/__main__.py``)
  and the obs surfaces it runs on (``obs/flight.py``, ``report.py``, ``health.py``,
  ``series.py``, ``prom.py``) are in both scans, no source names a ``metrics_tpu.``
  module in a string (a ``sys.modules`` lookup would read the JAX package's live
  objects), and a ``MetricsServer`` whose config names no device raises where CUDA is
  absent, as does a health monitor;
- the rest of ``obs/`` (``scopes``, ``recompile``, ``flow``, ``trace``, ``export``,
  ``aggregate``) is in both scans;
- the model metrics (BERTScore, InfoLM, CLIPScore, LPIPS, ``models/bert.py``,
  ``models/clip.py``, ``models/lpips.py``, ``multimodal/``) are in both scans, and the
  fresh import loads no ``transformers`` for them either; BERTScore and InfoLM are in
  the text sweep above (their default encoders raise for the device before they load
  anything), LPIPS in the image sweep.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.torch_deadline import deadline  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "metrics_tpu_torch"
SOURCES = (
    sorted(PACKAGE.rglob("*.py"))
    + [REPO / "chip_smoke.py", REPO / "tests" / "torch_sync_ranks.py", REPO / "tests" / "test_torch_image_card.py",
       REPO / "tests" / "torch_detection_ranks.py", REPO / "tests" / "test_torch_detection_card.py"]
    + sorted((REPO / "scripts").glob("torch_*.py"))
)
# modules the scans must reach: the runtime core for many ranks and its classes
REQUIRED_MODULES = (
    "metrics_tpu_torch.parallel", "metrics_tpu_torch.parallel.collective", "metrics_tpu_torch.utils.distributed",
    "metrics_tpu_torch.core.collections", "metrics_tpu_torch.core.aggregation",
    "metrics_tpu_torch.classification.specificity", "metrics_tpu_torch.classification.hamming",
    "metrics_tpu_torch.classification.cohen_kappa", "metrics_tpu_torch.classification.matthews_corrcoef",
    "metrics_tpu_torch.classification.exact_match", "metrics_tpu_torch.functional.classification.specificity",
    "metrics_tpu_torch.functional.classification.hamming", "metrics_tpu_torch.functional.classification.cohen_kappa",
    "metrics_tpu_torch.functional.classification.matthews_corrcoef",
    "metrics_tpu_torch.functional.classification.exact_match",
    # the rest of classification, the retrieval shims and the root exports
    "metrics_tpu_torch", "metrics_tpu_torch.functional", "metrics_tpu_torch.retrieval._deprecated",
    "metrics_tpu_torch.functional.retrieval._deprecated",
    *(f"metrics_tpu_torch.{kind}.{module}" for kind in ("classification", "functional.classification")
      for module in ("recall_fixed_precision", "precision_fixed_recall", "specificity_sensitivity",
                     "calibration_error", "hinge", "ranking", "group_fairness", "dice")),
    "metrics_tpu_torch.functional.classification._legacy",
    # image and pairwise, the InceptionV3 and their shims
    *(f"metrics_tpu_torch.image.{m}" for m in ("ssim", "psnr", "psnrb", "uqi", "d_lambda", "ergas", "rase",
                                               "rmse_sw", "sam", "tv", "fid", "kid", "inception", "_deprecated")),
    *(f"metrics_tpu_torch.functional.image.{m}" for m in ("helper", "ssim", "psnr", "psnrb", "uqi", "d_lambda",
                                                          "ergas", "rase", "rmse_sw", "sam", "tv", "gradients",
                                                          "fid_math", "_deprecated")),
    *(f"metrics_tpu_torch.functional.pairwise.{m}" for m in ("helpers", "cosine", "euclidean", "linear",
                                                             "manhattan", "minkowski")),
    "metrics_tpu_torch.models.inception", "metrics_tpu_torch.models._io",
    # detection, its greedy-match kernel and their shims
    *(f"metrics_tpu_torch.detection.{m}" for m in ("helpers", "rle", "iou", "giou", "diou", "ciou", "mean_ap",
                                                   "panoptic_qualities", "_deprecated")),
    *(f"metrics_tpu_torch.functional.detection.{m}" for m in ("box_ops", "iou", "giou", "diou", "ciou",
                                                              "_mean_ap_kernel", "_mean_ap_device",
                                                              "_panoptic_quality_common", "panoptic_qualities",
                                                              "_deprecated")),
    "metrics_tpu_torch.detection", "metrics_tpu_torch.functional.detection", "metrics_tpu_torch.ops.greedy_match",
    # regression and audio, the Kendall kernel and their shims
    *(f"metrics_tpu_torch.{kind}.{m}" for kind in ("regression", "functional.regression")
      for m in ("concordance", "cosine_similarity", "explained_variance", "kendall", "kl_divergence", "log_cosh",
                "log_mse", "mae", "mape", "minkowski", "mse", "pearson", "r2", "spearman", "symmetric_mape",
                "tweedie_deviance", "wmape")),
    *(f"metrics_tpu_torch.{kind}.{m}" for kind in ("audio", "functional.audio")
      for m in ("pesq", "pit", "sdr", "snr", "stoi", "_deprecated")),
    "metrics_tpu_torch.regression", "metrics_tpu_torch.functional.regression", "metrics_tpu_torch.audio",
    "metrics_tpu_torch.functional.audio", "metrics_tpu_torch.ops.kendall", "metrics_tpu_torch.utils.imports",
    # the string metrics, perplexity and their shims
    *(f"metrics_tpu_torch.{kind}.{m}" for kind in ("text", "functional.text")
      for m in ("bleu", "cer", "chrf", "eed", "mer", "perplexity", "rouge", "sacre_bleu", "squad", "ter", "wer",
                "wil", "wip", "_deprecated")),
    "metrics_tpu_torch.text", "metrics_tpu_torch.functional.text", "metrics_tpu_torch.functional.text.helper",
    # the model metrics, their networks and the multimodal packages
    "metrics_tpu_torch.text.bert", "metrics_tpu_torch.text.infolm", "metrics_tpu_torch.functional.text.bert",
    "metrics_tpu_torch.functional.text.infolm", "metrics_tpu_torch.image.lpip", "metrics_tpu_torch.functional.image.lpips",
    "metrics_tpu_torch.multimodal", "metrics_tpu_torch.multimodal.clip_score", "metrics_tpu_torch.functional.multimodal",
    "metrics_tpu_torch.functional.multimodal.clip_score", "metrics_tpu_torch.models._transformer",
    "metrics_tpu_torch.models.bert", "metrics_tpu_torch.models.clip", "metrics_tpu_torch.models.lpips",
    # durable and coalesced state: checkpoints, faults, the ingest queue and what they need
    *(f"metrics_tpu_torch.ckpt.{m}" for m in ("errors", "manifest", "serializer", "restore", "manager")),
    "metrics_tpu_torch.ckpt", "metrics_tpu_torch.fault", "metrics_tpu_torch.fault.inject", "metrics_tpu_torch.serve",
    "metrics_tpu_torch.serve.ingest", "metrics_tpu_torch.obs", "metrics_tpu_torch.obs.ring",
    "metrics_tpu_torch.obs.registry", "metrics_tpu_torch.utils.concurrency",
    # the metrics server, its command line and warm restarts, and the obs surfaces they run on
    *(f"metrics_tpu_torch.obs.{m}" for m in ("flight", "report", "health", "series", "prom")),
    # the rest of obs: scopes, retrace detection, flow tracing, the exports, aggregation
    *(f"metrics_tpu_torch.obs.{m}" for m in ("scopes", "recompile", "flow", "trace", "export", "aggregate")),
    *(f"metrics_tpu_torch.serve.{m}" for m in ("excache", "server", "__main__")),
    # the cost cross-check on its launch budget, and the plots
    "metrics_tpu_torch.obs.costcheck", "metrics_tpu_torch.obs.canon", "metrics_tpu_torch.utils.plot",
)


def _module_names():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_loads_no_jax_and_no_metrics_tpu():
    assert set(REQUIRED_MODULES) <= set(_module_names())
    code = (
        "import importlib, sys\n"
        f"for name in {list(_module_names())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'metrics_tpu' or m.startswith('metrics_tpu.')"
        " or m.split('.')[0] in ('nltk', 'transformers', 'tokenizers', 'sacrebleu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_metrics_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "metrics_tpu"), f"{path.name}:{node.lineno} imports {name}"


def test_metric_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.classification import MulticlassAccuracy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MulticlassAccuracy(num_classes=3)


def test_aggregators_stat_classes_and_collections_without_device_raise_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch import classification as tc
    from metrics_tpu_torch.core import MetricCollection, aggregation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [getattr(aggregation, n) for n in ("MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric")]
    makers += [
        lambda: tc.MulticlassSpecificity(num_classes=3), lambda: tc.MulticlassHammingDistance(num_classes=3),
        lambda: tc.MulticlassCohenKappa(num_classes=3), lambda: tc.MulticlassMatthewsCorrCoef(num_classes=3),
        lambda: tc.MulticlassExactMatch(num_classes=3),
        lambda: MetricCollection([tc.MulticlassAccuracy(num_classes=3), tc.MulticlassRecall(num_classes=3)]),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_functional_numpy_input_goes_to_cuda_by_default(monkeypatch):
    from metrics_tpu_torch.functional.classification import binary_auroc, multiclass_accuracy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multiclass_accuracy(np.array([0, 1]), np.array([0, 1]), num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binary_auroc(np.array([0.2, 0.7], np.float32), np.array([0, 1]))
    from metrics_tpu_torch.functional.classification import matthews_corrcoef, specificity

    for fn in (specificity, matthews_corrcoef):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(np.array([0, 1]), np.array([0, 1]), task="multiclass", num_classes=3)


def test_curve_metric_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAveragePrecision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (BinaryAUROC, lambda: MulticlassAveragePrecision(num_classes=3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cpu_run_imports_the_kernel_module_without_nvcc():
    code = (
        "import numpy as np\n"
        "from metrics_tpu_torch.ops import histogram, segment\n"
        "from metrics_tpu_torch.classification import BinaryAUROC, MulticlassJaccardIndex\n"
        "m = MulticlassJaccardIndex(num_classes=19, ignore_index=255, device='cpu')\n"
        "rng = np.random.RandomState(0)\n"
        "t = rng.randint(0, 19, (2, 8, 8)); t[0, 0] = 255\n"
        "m.update(rng.randn(2, 19, 8, 8).astype(np.float32), t)\n"
        "m.compute()\n"
        "a = BinaryAUROC(device='cpu')\n"
        "a.update(rng.rand(64).astype(np.float32), rng.randint(0, 2, 64))\n"
        "assert 0.0 <= float(a.compute()) <= 1.0\n"
        "assert histogram.histogram_cuda.launches == 0 and segment.segment_scan_cuda.launches == 0\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": os.environ.get("HOME", "/tmp")}
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_rest_of_classification_without_device_raises_when_cuda_is_absent(monkeypatch):
    import metrics_tpu_torch
    from metrics_tpu_torch import classification as tc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda: tc.BinaryRecallAtFixedPrecision(0.5), lambda: tc.MulticlassPrecisionAtFixedRecall(3, 0.5),
        lambda: tc.MultilabelSpecificityAtSensitivity(3, 0.5), lambda: tc.RecallAtFixedPrecision("binary", 0.5),
        tc.BinaryCalibrationError, lambda: tc.MulticlassCalibrationError(3), lambda: tc.CalibrationError("binary"),
        tc.BinaryHingeLoss, lambda: tc.MulticlassHingeLoss(3), lambda: tc.MultilabelCoverageError(3),
        lambda: tc.MultilabelRankingAveragePrecision(3), lambda: tc.MultilabelRankingLoss(3),
        lambda: tc.BinaryGroupStatRates(2), lambda: tc.BinaryFairness(2), tc.Dice,
        lambda: metrics_tpu_torch.Dice(),
        lambda: metrics_tpu_torch.MetricCollection([metrics_tpu_torch.HingeLoss("binary")]),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    from metrics_tpu_torch.functional.classification import binary_calibration_error, binary_fairness, dice

    with pytest.raises(RuntimeError, match="no CUDA device"):
        binary_calibration_error(np.array([0.2, 0.7], np.float32), np.array([0, 1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binary_fairness(np.array([0.2, 0.7], np.float32), np.array([0, 1]), np.array([0, 1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dice(np.array([0, 1]), np.array([0, 1]))


def test_cpu_run_of_calibration_fairness_and_fixed_points_launches_no_kernel():
    code = (
        "import numpy as np\n"
        "from metrics_tpu_torch.ops import histogram, segment\n"
        "from metrics_tpu_torch import classification as tc\n"
        "rng = np.random.RandomState(0)\n"
        "p, t = rng.rand(256).astype(np.float32), rng.randint(0, 2, 256)\n"
        "for m in (tc.BinaryCalibrationError(device='cpu'), tc.BinaryRecallAtFixedPrecision(0.5, device='cpu'),\n"
        "          tc.BinaryPrecisionAtFixedRecall(0.5, device='cpu'),\n"
        "          tc.BinarySpecificityAtSensitivity(0.5, device='cpu')):\n"
        "    m.update(p, t)\n"
        "    m.compute()\n"
        "f = tc.BinaryFairness(7, device='cpu')\n"
        "f.update(p, t, rng.randint(0, 7, 256))\n"
        "f.compute()\n"
        "assert histogram.histogram_cuda.launches == 0 and segment.segment_scan_cuda.launches == 0\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": os.environ.get("HOME", "/tmp")}
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_image_and_pairwise_without_device_raise_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch import image as ti
    from metrics_tpu_torch.functional import image as tfi
    from metrics_tpu_torch.functional import pairwise as tp
    from metrics_tpu_torch.models.inception import FeatureExtractorInceptionV3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extractor = lambda imgs: imgs.reshape(imgs.shape[0], -1)  # noqa: E731
    makers = [getattr(ti, name) for name in ti.__all__ if "Inception" not in name]
    makers += [lambda: ti.FrechetInceptionDistance(feature=extractor), lambda: ti.InceptionScore(feature=extractor),
               lambda: ti.KernelInceptionDistance(feature=extractor), FeatureExtractorInceptionV3]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    img = np.random.RandomState(0).rand(1, 3, 24, 24).astype(np.float32)
    for name in tfi.__all__:
        args = (img,) if name in ("total_variation", "image_gradients") else (img, img)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tfi, name)(*args)
    for name in tp.__all__:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tp, name)(img[0, 0])


def test_detection_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch import detection as td
    from metrics_tpu_torch.functional import detection as tfd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    categories = {"things": {0}, "stuffs": {6}}
    kwargs = {"PanopticQuality": categories, "ModifiedPanopticQuality": categories}
    for name in td.__all__:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(td, name)(**kwargs.get(name, {}))
    boxes = np.array([[0.0, 0.0, 2.0, 2.0]], np.float32)
    for name in tfd.__all__:
        if "panoptic" in name:
            args, extra = (np.array([[[0, 0]]]), np.array([[[0, 0]]])), {"things": {0}, "stuffs": {6}}
        elif name in ("box_area", "box_convert"):
            args, extra = (boxes,), ({"in_fmt": "xywh"} if name == "box_convert" else {})
        else:
            args, extra = (boxes, boxes), {}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tfd, name)(*args, **extra)


def test_cpu_map_compute_launches_no_greedy_match_kernel():
    code = (
        "import numpy as np, torch\n"
        "from metrics_tpu_torch.ops import greedy_match, histogram\n"
        "from metrics_tpu_torch.detection import MeanAveragePrecision, PanopticQuality\n"
        "rng = np.random.RandomState(0)\n"
        "b = torch.from_numpy(rng.rand(2, 5, 4).astype(np.float32) * 50); b[..., 2:] += b[..., :2] + 1\n"
        "s = torch.from_numpy(rng.rand(2, 5).astype(np.float32)); l = torch.from_numpy(rng.randint(0, 3, (2, 5)))\n"
        "for layout in ('list', 'consolidated'):\n"
        "    m = MeanAveragePrecision(device='cpu')\n"
        "    if layout == 'list':\n"
        "        m.update([dict(boxes=b[i], scores=s[i], labels=l[i]) for i in range(2)],\n"
        "                 [dict(boxes=b[i], labels=l[i]) for i in range(2)])\n"
        "    else:\n"
        "        m.update(dict(boxes=b, scores=s, labels=l), dict(boxes=b, labels=l))\n"
        "    assert float(m.compute()['map']) == 1.0\n"
        "pq = PanopticQuality(things={0}, stuffs={6}, device='cpu')\n"
        "pq.update(torch.tensor([[[0, 0], [6, 0]]]), torch.tensor([[[0, 0], [6, 0]]]))\n"
        "assert float(pq.compute()) == 1.0\n"
        "assert greedy_match.greedy_match_cuda.launches == 0 and histogram.histogram_cuda.launches == 0\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": os.environ.get("HOME", "/tmp")}
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_regression_and_audio_without_device_raise_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch import audio as ta
    from metrics_tpu_torch import regression as tr
    from metrics_tpu_torch.functional import audio as tfa
    from metrics_tpu_torch.functional import regression as tfr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"MinkowskiDistance": (2,), "PermutationInvariantTraining": (tfa.signal_noise_ratio,),
            "ShortTimeObjectiveIntelligibility": (8000,), "PerceptualEvaluationSpeechQuality": (8000, "nb")}
    for name in tr.__all__ + ta.__all__:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tr if name in tr.__all__ else ta, name)(*args.get(name, ()))
    x = np.random.RandomState(0).rand(2, 3, 40).astype(np.float32)
    extra = {"minkowski_distance": (2,), "permutation_invariant_training": (tfa.signal_noise_ratio,),
             "short_time_objective_intelligibility": (8000,), "perceptual_evaluation_speech_quality": (8000, "nb")}
    for module, name in [(tfr, n) for n in tfr.__all__] + [(tfa, n) for n in tfa.__all__]:
        if name == "perceptual_evaluation_speech_quality":
            continue  # raises for the missing package before it reads its inputs
        inputs = (x[0], x[0]) if module is tfr else (x, x)
        if name == "pit_permutate":
            inputs = (x, np.zeros((2, 3), np.int64))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(module, name)(*inputs, *extra.get(name, ()))


def test_cpu_spearman_and_kendall_compute_launch_no_kernel():
    code = (
        "import numpy as np, torch\n"
        "from metrics_tpu_torch.ops import greedy_match, histogram, kendall, segment\n"
        "from metrics_tpu_torch.regression import KendallRankCorrCoef, PearsonCorrCoef, SpearmanCorrCoef\n"
        "rng = np.random.RandomState(0)\n"
        "p, t = rng.rand(64, 3).astype(np.float32), rng.rand(64, 3).astype(np.float32)\n"
        "for m in (SpearmanCorrCoef(num_outputs=3, device='cpu'), KendallRankCorrCoef(num_outputs=3, device='cpu'),\n"
        "          KendallRankCorrCoef(num_outputs=3, variant='c', t_test=True, cat_capacity=128, device='cpu'),\n"
        "          PearsonCorrCoef(num_outputs=3, device='cpu')):\n"
        "    m.update(torch.from_numpy(p), torch.from_numpy(t))\n"
        "    m.compute()\n"
        "assert (kendall.kendall_pairs_cuda.launches, segment.segment_scan_cuda.launches,\n"
        "        histogram.histogram_cuda.launches, greedy_match.greedy_match_cuda.launches) == (0, 0, 0, 0)\n"
        "print('ok')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": os.environ.get("HOME", "/tmp")}
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_text_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch import text as tt
    from metrics_tpu_torch.functional import text as tft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in tt.__all__:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tt, name)()
    squad_args = ([{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}])
    logits = np.random.RandomState(0).rand(2, 3, 5).astype(np.float32)
    inputs = {"squad": squad_args, "perplexity": (logits, np.zeros((2, 3), np.int64))}
    for name in tft.__all__:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tft, name)(*inputs.get(name, (["a b"], [["a b"]])))


def test_ingest_queue_over_a_metric_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.core.fused import canonical_collection
    from metrics_tpu_torch.regression import MeanSquaredError
    from metrics_tpu_torch.serve import IngestQueue, active_queues

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (MeanSquaredError, canonical_collection):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IngestQueue(make(), start=False)
    assert active_queues() == []


def _looked_up_names(tree):
    """The string arguments of ``sys.modules.get(...)``, ``sys.modules[...]`` and
    ``import_module(...)``."""
    for node in ast.walk(tree):
        target = None
        if isinstance(node, ast.Call) and node.args:
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "get" and isinstance(func.value, ast.Attribute) \
                    and func.value.attr == "modules":
                target = node.args[0]
            elif isinstance(func, (ast.Attribute, ast.Name)) and getattr(func, "attr", getattr(func, "id", "")) \
                    == "import_module":
                target = node.args[0]
        elif isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute) and node.value.attr == "modules":
            target = node.slice
        if isinstance(target, ast.Constant) and isinstance(target.value, str):
            yield node.lineno, target.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_looks_up_no_metrics_tpu_module_by_name(path):
    for lineno, name in _looked_up_names(ast.parse(path.read_text(), filename=str(path))):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "metrics_tpu"), f"{path.name}:{lineno} looks up {name!r}"


def test_metrics_server_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.obs import health
    from metrics_tpu_torch.serve import MetricsServer, ServerConfig, active_queues
    from metrics_tpu_torch.serve.server import active_servers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = {"collections": [{"name": "a", "metrics": {"mse": "MeanSquaredError"}}]}
    assert ServerConfig.from_dict(config).device == "cuda"
    for start in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MetricsServer(config, start=start, ticker=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        health.enable()
    assert active_servers() == [] and active_queues() == [] and not health.active()


def test_launch_budget_is_the_ports_own_file():
    from metrics_tpu_torch.obs import costcheck

    path = pathlib.Path(costcheck.default_costs_path())
    assert path == PACKAGE / "obs" / "launch_budget.json"
    payload = json.loads(path.read_text())
    # stamped on the card with torch, CUDA and the card's name, not with jax and a backend
    assert set(payload["stamp"]) == {"torch", "cuda", "device"} and "jax" not in payload and "backend" not in payload
    assert "H100" in payload["stamp"]["device"] and payload["stamp"]["cuda"]
    entries = payload["entries"]
    assert costcheck.FUSED_KEY in entries and entries[costcheck.FUSED_KEY]["replays_per_step"] == 1
    assert all(set(e) == {"launches_per_update", "kernel_launches_per_update", "cuda_kernels_per_update",
                          "cuda_copies_per_update"} for k, e in entries.items() if k != costcheck.FUSED_KEY)
