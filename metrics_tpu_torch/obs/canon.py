"""The canonical update inputs of every metric class, drawn with numpy from a seed: the
port's copy of the tables behind the JAX package's compile-cost budget
(``metrics_tpu/analysis/san/abstract_inputs.py`` and the class walk and constructor
specs of ``metrics_tpu/analysis/registry.py``), with values in place of shapes.

:func:`budget_cases` walks the root exports as that budget does and gives, for each
class it budgets, the budget keys (``<Class>.update[canon]``, with the update's
keyword arguments after a colon where the spec has some) with a fresh metric and the
update's arguments; and for each export it does not budget, the reason (the same
reasons: no weights, host code by contract, no input spec).
"""
import inspect
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: the canonical batch size of the budget (the JAX package's ``SIZES["canon"]``)
CANON = 64


def _flat8_feature(x: torch.Tensor) -> torch.Tensor:
    """Weight-free stand-in feature extractor for FID, KID and IS."""
    return x.to(torch.float32).reshape(x.shape[0], -1)[:, :8]


# ------------------------------------------------------------ update inputs
# inputs(rng, n) -> [(args, kwargs)], numpy arrays of the JAX specs' shapes and dtypes


def _f32(rng, *shape):
    return rng.random(shape, dtype=np.float32)


def _one(*args, **kwargs):
    return [(args, kwargs)]


def _binary(rng, n):
    return _one(_f32(rng, n), rng.integers(0, 2, n, dtype=np.int32))


def _multiclass(rng, n):
    return _one(_f32(rng, n, 5), rng.integers(0, 5, n, dtype=np.int32))


def _multilabel(rng, n):
    return _one(_f32(rng, n, 3), rng.integers(0, 2, (n, 3), dtype=np.int32))


def _retrieval(rng, n):
    return _one(_f32(rng, n), rng.integers(0, 2, n, dtype=np.int32), rng.integers(0, 8, n, dtype=np.int32))


def _pairs(rng, n):
    return _one(_f32(rng, n), _f32(rng, n))


def _single(rng, n):
    return _one(_f32(rng, n))


def _ids(rng, n, high):
    return rng.integers(0, high, n, dtype=np.int32)


def _img(n, c=3, hw=16):
    return max(1, n // 32), c, hw, hw


def _img_pair(rng, n, c=3, hw=16):
    return _one(_f32(rng, *_img(n, c, hw)), _f32(rng, *_img(n, c, hw)))


def _sig_pair(rng, n, t=32):
    b = max(1, n // 32)
    return _one(rng.standard_normal((b, t), dtype=np.float32), rng.standard_normal((b, t), dtype=np.float32))


def _uint8_images(rng, n):
    return rng.integers(0, 256, (max(2, n // 16), 3, 8, 8), dtype=np.uint8)


FAMILY_INPUTS: Tuple[Tuple[str, Callable], ...] = (
    ("Binary", _binary),
    ("Multiclass", _multiclass),
    ("Multilabel", _multilabel),
    ("Retrieval", _retrieval),
)

PER_NAME: Dict[str, Callable] = {
    **{name: _binary for name in (
        "Accuracy", "AUROC", "AveragePrecision", "CalibrationError", "CohenKappa", "ConfusionMatrix", "F1Score",
        "FBetaScore", "HammingDistance", "JaccardIndex", "MatthewsCorrCoef", "Precision", "PrecisionRecallCurve",
        "Recall", "ROC", "Specificity", "StatScores", "RecallAtFixedPrecision", "PrecisionAtFixedRecall",
        "SpecificityAtSensitivity", "HingeLoss")},
    "ExactMatch": lambda rng, n: _one(_ids(rng, n, 5), _ids(rng, n, 5)),
    "MulticlassExactMatch": lambda rng, n: _one(_ids(rng, n, 5), _ids(rng, n, 5)),
    "MultilabelExactMatch": _multilabel,
    "CosineSimilarity": lambda rng, n: _one(_f32(rng, max(2, n // 16), 8), _f32(rng, max(2, n // 16), 8)),
    "KLDivergence": lambda rng, n: _one(_f32(rng, max(2, n // 8), 4), _f32(rng, max(2, n // 8), 4)),
    **{name: _pairs for name in (
        "KendallRankCorrCoef", "SpearmanCorrCoef", "PearsonCorrCoef", "ConcordanceCorrCoef", "ExplainedVariance",
        "LogCoshError", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanSquaredError",
        "MeanSquaredLogError", "MinkowskiDistance", "R2Score", "SymmetricMeanAbsolutePercentageError",
        "TweedieDevianceScore", "WeightedMeanAbsolutePercentageError")},
    **{name: _single for name in (
        "MaxMetric", "MinMetric", "MeanMetric", "SumMetric", "CatMetric", "RunningMean", "RunningSum",
        "QuantileSketch")},
    **{name: _img_pair for name in (
        "ErrorRelativeGlobalDimensionlessSynthesis", "PeakSignalNoiseRatio", "RelativeAverageSpectralError",
        "RootMeanSquaredErrorUsingSlidingWindow", "SpectralAngleMapper", "SpectralDistortionIndex",
        "StructuralSimilarityIndexMeasure", "UniversalImageQualityIndex")},
    "MultiScaleStructuralSimilarityIndexMeasure": lambda rng, n: _img_pair(rng, n, hw=24),
    "PeakSignalNoiseRatioWithBlockedEffect": lambda rng, n: _img_pair(rng, n, c=1),
    "TotalVariation": lambda rng, n: _one(_f32(rng, *_img(n))),
    **{name: _sig_pair for name in (
        "ScaleInvariantSignalDistortionRatio", "ScaleInvariantSignalNoiseRatio", "SignalNoiseRatio")},
    "SignalDistortionRatio": lambda rng, n: _sig_pair(rng, n, t=64),
    "PermutationInvariantTraining": lambda rng, n: _one(
        rng.standard_normal((max(1, n // 32), 2, 32), dtype=np.float32),
        rng.standard_normal((max(1, n // 32), 2, 32), dtype=np.float32)),
    "Perplexity": lambda rng, n: _one(rng.standard_normal((max(1, n // 32), 6, 8), dtype=np.float32),
                                      rng.integers(0, 8, (max(1, n // 32), 6), dtype=np.int32)),
    "DistinctCount": lambda rng, n: _one(_ids(rng, n, 1 << 20)),
    "HistogramDrift": lambda rng, n: [((_f32(rng, n),), {"reference": True}), ((_f32(rng, n),), {"reference": False})],
    "StreamingAUROCBound": _binary,
    **{name: (lambda rng, n: _one(_ids(rng, n, 4), _ids(rng, n, 4))) for name in (
        "CramersV", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT")},
    "FrechetInceptionDistance": lambda rng, n: [((_uint8_images(rng, n),), {"real": True}),
                                                ((_uint8_images(rng, n),), {"real": False})],
    "KernelInceptionDistance": lambda rng, n: [((_uint8_images(rng, n),), {"real": True}),
                                               ((_uint8_images(rng, n),), {"real": False})],
    "InceptionScore": lambda rng, n: _one(_uint8_images(rng, n)),
    # the wrappers: the wrapped metric's inputs (MultioutputWrapper's with a trailing output axis)
    "BootStrapper": _multiclass,
    "ClasswiseWrapper": _multiclass,
    "MinMaxMetric": _binary,
    "MultioutputWrapper": lambda rng, n: _one(_f32(rng, n, 2), _f32(rng, n, 2)),
}


# ------------------------------------------------------------- constructors


def _ctor_specs(device: Any) -> Dict[str, Callable[[], Dict[str, Any]]]:
    """Constructor keyword arguments by export name (thunks: some build sub-metrics)."""
    import metrics_tpu_torch as tm
    from metrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio

    def kw(**kwargs):
        return lambda: kwargs

    binary_thresholds = {"thresholds": 11}
    return {
        "Accuracy": kw(task="binary"),
        "AUROC": kw(task="binary"),
        "AveragePrecision": kw(task="binary"),
        "CalibrationError": kw(task="binary"),
        "CohenKappa": kw(task="binary"),
        "ConfusionMatrix": kw(task="binary"),
        "ExactMatch": kw(task="multiclass", num_classes=5),
        "F1Score": kw(task="binary"),
        "FBetaScore": kw(task="binary", beta=0.5),
        "HammingDistance": kw(task="binary"),
        "HingeLoss": kw(task="binary"),
        "JaccardIndex": kw(task="binary"),
        "MatthewsCorrCoef": kw(task="binary"),
        "Precision": kw(task="binary"),
        "PrecisionRecallCurve": kw(task="binary", **binary_thresholds),
        "Recall": kw(task="binary"),
        "ROC": kw(task="binary", **binary_thresholds),
        "Specificity": kw(task="binary"),
        "StatScores": kw(task="binary"),
        "RecallAtFixedPrecision": kw(task="binary", min_precision=0.5, **binary_thresholds),
        "PrecisionAtFixedRecall": kw(task="binary", min_recall=0.5, **binary_thresholds),
        "SpecificityAtSensitivity": kw(task="binary", min_sensitivity=0.5, **binary_thresholds),
        "MinkowskiDistance": kw(p=3),
        "TweedieDevianceScore": kw(power=1.5),
        "MultiScaleStructuralSimilarityIndexMeasure": kw(data_range=1.0, betas=(0.5, 0.5), kernel_size=3),
        "PeakSignalNoiseRatio": kw(data_range=1.0),
        "PeakSignalNoiseRatioWithBlockedEffect": kw(block_size=4),
        "RelativeAverageSpectralError": kw(window_size=4),
        "RootMeanSquaredErrorUsingSlidingWindow": kw(window_size=4),
        "StructuralSimilarityIndexMeasure": kw(data_range=1.0),
        "SignalDistortionRatio": kw(filter_length=4, load_diag=1e-4),
        "PanopticQuality": kw(things={0}, stuffs={1}),
        "ModifiedPanopticQuality": kw(things={0}, stuffs={1}),
        "CramersV": kw(num_classes=4),
        "PearsonsContingencyCoefficient": kw(num_classes=4),
        "TheilsU": kw(num_classes=4),
        "TschuprowsT": kw(num_classes=4),
        "FrechetInceptionDistance": kw(feature=_flat8_feature, num_features=8),
        "KernelInceptionDistance": kw(feature=_flat8_feature, subset_size=4, subsets=2),
        "InceptionScore": kw(feature=_flat8_feature),
        "PermutationInvariantTraining": kw(metric_func=scale_invariant_signal_noise_ratio, eval_func="max"),
        "BootStrapper": lambda: {"base_metric": tm.MulticlassAccuracy(num_classes=5, average="micro",
                                                                      validate_args=False, device=device),
                                 "num_bootstraps": 4, "seed": 0},
        "MultioutputWrapper": lambda: {"base_metric": tm.MeanSquaredError(device=device), "num_outputs": 2,
                                       "remove_nans": False},
        "ClasswiseWrapper": lambda: {"metric": tm.MulticlassAccuracy(num_classes=5, average=None, device=device)},
        "MinMaxMetric": lambda: {"base_metric": tm.BinaryAccuracy(device=device)},
        "MetricTracker": lambda: {"metric": tm.BinaryAccuracy(device=device)},
    }


FAMILY_KWARGS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("Binary", {}),
    ("Multiclass", {"num_classes": 5}),
    ("Multilabel", {"num_labels": 3}),
    ("Retrieval", {}),
)

#: root exports the budget does not construct, with the JAX package's reasons
NOT_INTROSPECTED: Dict[str, str] = {
    "Metric": "the ABC itself",
    "CompositionalMetric": "built by operator overloads, not directly",
    "MetricCollection": "container, not a Metric (its members are introspected individually)",
    "BERTScore": "needs a pretrained encoder (no network egress)",
    "InfoLM": "needs a pretrained masked-LM (no network egress)",
    "CLIPScore": "needs pretrained CLIP (no network egress)",
    "LearnedPerceptualImagePatchSimilarity": "needs backbone weights (no network egress)",
    "PerceptualEvaluationSpeechQuality": "delegates to the optional pesq wheel",
    "ShortTimeObjectiveIntelligibility": "optional DSP dependency pipeline",
}


#: wrappers whose device is their wrapped metric's (no ``device`` argument)
_DEVICE_OF_BASE = {"ClasswiseWrapper", "MetricTracker"}


def _inputs_for(name: str) -> Optional[Callable]:
    if name in PER_NAME:
        return PER_NAME[name]
    for prefix, fam in FAMILY_INPUTS:
        if name.startswith(prefix):
            return fam
    return None


def _tag(kwargs: Dict[str, Any]) -> str:
    return "canon" + (":" + ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) if kwargs else "")


Case = Tuple[str, Callable[[], Any], Tuple[torch.Tensor, ...], Dict[str, Any]]


def budget_cases(device: Any, seed: int = 0) -> Tuple[List[Case], Dict[str, str]]:
    """``(cases, skipped)``: for each budgeted update, ``(key, make_metric, args,
    kwargs)`` with the arguments on ``device``; for each root export without one, the
    reason, keyed by its export name."""
    import metrics_tpu_torch as tm
    from metrics_tpu_torch.core.metric import Metric

    specs = _ctor_specs(device)
    rng = np.random.default_rng(seed)
    cases: List[Case] = []
    skipped: Dict[str, str] = {}
    seen: set = set()
    for name in sorted(set(tm.__all__)):
        cls = getattr(tm, name, None)
        if not inspect.isclass(cls):
            continue
        if name in NOT_INTROSPECTED:
            skipped[name] = NOT_INTROSPECTED[name]
            continue
        kwargs_thunk = specs.get(name) or (lambda name=name: next(
            (dict(kw) for prefix, kw in FAMILY_KWARGS if name.startswith(prefix)), {}))

        def make(cls=cls, thunk=kwargs_thunk, on={} if name in _DEVICE_OF_BASE else {"device": device}):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the root exports' FutureWarning shims
                return cls(**thunk(), **on)

        try:
            instance = make()
        except Exception as err:  # noqa: BLE001 - a class that cannot be built is a recorded skip
            skipped[name] = f"construction failed: {type(err).__name__}: {err}"
            continue
        if not isinstance(instance, Metric):
            skipped[name] = "dispatcher returned a non-Metric"
            continue
        if getattr(type(instance), "_host_side_update", False):
            skipped[name] = "declared _host_side_update (host code by contract)"
            continue
        if type(instance) in seen:  # a dispatcher's alias of a class budgeted already
            continue
        seen.add(type(instance))
        inputs = _inputs_for(name)
        if inputs is None:
            skipped[name] = "no canonical input spec"
            continue
        for args, kwargs in inputs(rng, CANON):
            key = f"{type(instance).__name__}.update[{_tag(kwargs)}]"
            tensors = tuple(torch.from_numpy(a).to(device) for a in args)
            cases.append((key, make, tensors, kwargs))
    return cases, skipped
