"""The plots of metrics_tpu_torch against the JAX package's, on the CPU, with
matplotlib's Agg backend: ``Metric.plot`` (a scalar, a per-class value, a series of
values), ``MetricCollection.plot`` (a grid and ``together``), the ROC and PR-curve
plots, the confusion-matrix heatmaps, the reliability diagrams, the two retrieval
curve plots and the helpers of ``utils/plot.py``.

Each pair of figures comes from the same seeded numpy inputs. What is compared: every
line's ``get_xydata()`` and every image's array (counts bit-equal, floats within
float32 rounding), and the titles, axis labels, limits, tick labels, texts and legend
texts. Also the ``ValueError``s of ``MetricCollection.plot`` and the error without
matplotlib (its availability flag patched in both packages), and one deliberate
deviation: a scalar subclass of a curve class plots its value, where the JAX package's
curve plot raises.
"""
import inspect
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import metrics_tpu  # noqa: E402
import metrics_tpu.classification  # noqa: E402,F401
import metrics_tpu.regression  # noqa: E402,F401
import metrics_tpu.retrieval  # noqa: E402,F401
import metrics_tpu.utils.imports as jimports  # noqa: E402
import metrics_tpu.utils.plot as jplot  # noqa: E402
import metrics_tpu_torch  # noqa: E402
import metrics_tpu_torch.classification  # noqa: E402,F401
import metrics_tpu_torch.regression  # noqa: E402,F401
import metrics_tpu_torch.retrieval  # noqa: E402,F401
import metrics_tpu_torch.utils.imports as timports  # noqa: E402
import metrics_tpu_torch.utils.plot as tplot  # noqa: E402
from metrics_tpu.core.collections import MetricCollection as JCollection  # noqa: E402
from metrics_tpu_torch.core import Metric, MetricCollection  # noqa: E402
from tests.torch_deadline import deadline  # noqa: F401,E402

CPU = {"device": "cpu"}
RNG = np.random.default_rng(7)
N = 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _closes_figures():
    yield
    plt.close("all")


def _binary():
    return RNG.random(N).astype(np.float32), RNG.integers(0, 2, N).astype(np.int32)


def _multiclass(c=4):
    return RNG.random((N, c)).astype(np.float32), RNG.integers(0, c, N).astype(np.int32)


def _multilabel(k=3):
    return RNG.random((N, k)).astype(np.float32), RNG.integers(0, 2, (N, k)).astype(np.int32)


def _class(package, name):
    for sub in ("classification", "regression", "retrieval"):
        if hasattr(getattr(package, sub), name):
            return getattr(getattr(package, sub), name)
    raise AttributeError(name)


def pair(name, *args, **kwargs):
    """The JAX and the port metric of one class name, built alike."""
    return _class(metrics_tpu, name)(*args, **kwargs), _class(metrics_tpu_torch, name)(*args, **kwargs, **CPU)


def update(jm, tm, *arrays, **kwargs):
    jm.update(*(jnp.asarray(a) for a in arrays), **{k: jnp.asarray(v) for k, v in kwargs.items()})
    tm.update(*(torch.from_numpy(a) for a in arrays), **{k: torch.from_numpy(v) for k, v in kwargs.items()})


def _axes(out):
    """Every axis of a plot's return value (a pair, a list of pairs, an axis array)."""
    if isinstance(out, list):
        return [a for fa in out for a in _axes(fa)]
    if isinstance(out, tuple):
        return _axes(out[1])
    if isinstance(out, np.ndarray) or hasattr(out, "__iter__") and not hasattr(out, "plot"):
        return list(out)
    return [out]


def _content(ax):
    legend = ax.get_legend()
    return {
        "lines": [ln.get_xydata() for ln in ax.get_lines()],
        "images": [np.asarray(im.get_array()) for im in ax.get_images()],
        "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height()) for p in ax.patches],
        "texts": [t.get_text() for t in ax.texts],
        "title": ax.get_title(),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "lims": (ax.get_xlim(), ax.get_ylim()),
        "ticks": ([t.get_text() for t in ax.get_xticklabels()], [t.get_text() for t in ax.get_yticklabels()]),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "xaxis": ax.get_xaxis().get_visible(),
    }


def assert_same_figures(got, want):
    got_axes, want_axes = _axes(got), _axes(want)
    assert len(got_axes) == len(want_axes)
    for g, w in zip(got_axes, want_axes):
        g, w = _content(g), _content(w)
        for key in ("texts", "title", "labels", "ticks", "legend", "xaxis"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(np.asarray(g["lims"]), np.asarray(w["lims"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(g["bars"]).reshape(-1), np.asarray(w["bars"]).reshape(-1),
                                   rtol=1e-6, atol=1e-7)
        assert len(g["lines"]) == len(w["lines"]) and len(g["images"]) == len(w["images"])
        for a, b in zip(g["lines"], w["lines"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(g["images"], w["images"]):
            if a.dtype.kind in "iu":  # the port's counts are integers, the JAX ones float32
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- Metric.plot


@pytest.mark.parametrize("name, args, data", [
    ("BinaryAccuracy", (), _binary),
    ("MeanSquaredError", (), lambda: (RNG.random(N).astype(np.float32), RNG.random(N).astype(np.float32))),
    ("MulticlassAccuracy", (4,), _multiclass),
])
def test_scalar_plot_equals_the_jax_package(name, args, data):
    jm, tm = pair(name, *args)
    update(jm, tm, *data())
    assert_same_figures(tm.plot(), jm.plot())


def test_per_class_value_plot_equals_the_jax_package():
    jm, tm = pair("MulticlassAccuracy", 4, average=None)
    update(jm, tm, *_multiclass())
    assert_same_figures(tm.plot(), jm.plot())


@pytest.mark.parametrize("average", ["micro", None])
def test_series_of_values_plot_equals_the_jax_package(average):
    jm, tm = pair("MulticlassAccuracy", 4, average=average)
    jvals, tvals = [], []
    for _ in range(3):
        p, t = _multiclass()
        jvals.append(jm(jnp.asarray(p), jnp.asarray(t)))
        tvals.append(tm(torch.from_numpy(p), torch.from_numpy(t)))
    assert_same_figures(tm.plot(tvals), jm.plot(jvals))


def test_bounds_and_direction_come_from_the_class():
    jm, tm = pair("BinaryCalibrationError")
    update(jm, tm, *_binary())
    fig_ax = tm.plot()
    assert_same_figures(fig_ax, jm.plot())
    assert "Lower is better" in [t.get_text() for t in fig_ax[1].texts]


def test_every_metric_class_has_plot_and_the_calibration_classes_a_reliability_diagram():
    classes = [getattr(metrics_tpu_torch, n) for n in metrics_tpu_torch.__all__]
    metric_classes = [c for c in classes if inspect.isclass(c) and issubclass(c, Metric)]
    assert len(metric_classes) > 100
    assert all(callable(getattr(c, "plot", None)) for c in metric_classes)
    for name in ("BinaryCalibrationError", "MulticlassCalibrationError"):
        assert callable(getattr(getattr(metrics_tpu_torch.classification, name), "plot_reliability_diagram"))


# ------------------------------------------------------ MetricCollection.plot


def _collections():
    names = [("BinaryAccuracy", ()), ("BinaryPrecision", ()), ("BinaryRecall", ())]
    jc = JCollection([_class(metrics_tpu, n)(*a) for n, a in names])
    tc = MetricCollection([_class(metrics_tpu_torch, n)(*a, **CPU) for n, a in names])
    return jc, tc


def test_collection_grid_and_together_equal_the_jax_package():
    jc, tc = _collections()
    jvals, tvals = [], []
    for _ in range(3):
        p, t = _binary()
        jvals.append(jc(jnp.asarray(p), jnp.asarray(t)))
        tvals.append(tc(torch.from_numpy(p), torch.from_numpy(t)))
    assert_same_figures(tc.plot(), jc.plot())
    assert_same_figures(tc.plot(together=True), jc.plot(together=True))
    assert_same_figures(tc.plot(tvals), jc.plot(jvals))
    assert_same_figures(tc.plot(tvals, together=True), jc.plot(jvals, together=True))
    fig, axs = plt.subplots(1, 3)
    jfig, jaxs = plt.subplots(1, 3)
    assert_same_figures(tc.plot(ax=axs), jc.plot(ax=jaxs))


@pytest.mark.parametrize("kwargs, match", [
    ({"together": "yes"}, "Expected argument `together` to be a boolean"),
    ({"together": True, "ax": [1, 2]}, "to be a matplotlib axis when `together=True`"),
    ({"ax": "not axes"}, "sequence of matplotlib axis objects with the same length"),
])
def test_collection_plot_raises_the_jax_value_errors(kwargs, match):
    jc, tc = _collections()
    p, t = _binary()
    jc.update(jnp.asarray(p), jnp.asarray(t))
    tc.update(torch.from_numpy(p), torch.from_numpy(t))
    with pytest.raises(ValueError) as want:
        jc.plot(**kwargs)
    with pytest.raises(ValueError, match=match) as got:
        tc.plot(**kwargs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- overrides


@pytest.mark.parametrize("name, args, kwargs, data", [
    ("BinaryROC", (), {}, _binary),
    ("BinaryROC", (), {"thresholds": 11}, _binary),
    ("MulticlassROC", (4,), {}, _multiclass),
    ("MultilabelROC", (3,), {"thresholds": 7}, _multilabel),
    ("BinaryPrecisionRecallCurve", (), {}, _binary),
    ("MulticlassPrecisionRecallCurve", (4,), {}, _multiclass),
    ("MulticlassPrecisionRecallCurve", (4,), {"thresholds": 9}, _multiclass),
    ("MultilabelPrecisionRecallCurve", (3,), {}, _multilabel),
])
def test_curve_plots_equal_the_jax_package(name, args, kwargs, data):
    jm, tm = pair(name, *args, **kwargs)
    update(jm, tm, *data())
    assert_same_figures(tm.plot(), jm.plot())


def test_curve_plot_with_scores_equals_the_jax_package():
    jm, tm = pair("MulticlassROC", 4)
    update(jm, tm, *_multiclass())
    score = np.array([0.5, 0.61, 0.72, 0.8], np.float32)
    assert_same_figures(tm.plot(score=torch.from_numpy(score)), jm.plot(score=jnp.asarray(score)))
    jb, tb = pair("BinaryROC")
    update(jb, tb, *_binary())
    assert_same_figures(tb.plot(score=torch.tensor(0.75)), jb.plot(score=jnp.asarray(0.75)))


@pytest.mark.parametrize("name, args, data, labels", [
    ("BinaryConfusionMatrix", (), _binary, None),
    ("MulticlassConfusionMatrix", (4,), _multiclass, None),
    ("MulticlassConfusionMatrix", (4,), _multiclass, ["a", "b", "c", "d"]),
    ("MultilabelConfusionMatrix", (3,), _multilabel, None),
    ("MultilabelConfusionMatrix", (3,), _multilabel, ["x", "y", "z"]),
])
def test_confusion_matrix_plots_equal_the_jax_package(name, args, data, labels):
    jm, tm = pair(name, *args)
    update(jm, tm, *data())
    got, want = tm.plot(labels=labels), jm.plot(labels=labels)
    assert_same_figures(got, want)
    assert np.issubdtype(np.asarray(_axes(got)[0].get_images()[0].get_array()).dtype, np.integer)


def test_normalized_confusion_matrix_plot_equals_the_jax_package():
    jm, tm = pair("MulticlassConfusionMatrix", 4, normalize="true")
    update(jm, tm, *_multiclass())
    assert_same_figures(tm.plot(add_text=True), jm.plot(add_text=True))


@pytest.mark.parametrize("name, args, data", [
    ("BinaryCalibrationError", (), _binary),
    ("MulticlassCalibrationError", (4,), _multiclass),
])
@pytest.mark.parametrize("n_bins", [5, 15])
def test_reliability_diagrams_equal_the_jax_package(name, args, data, n_bins):
    jm, tm = pair(name, *args, n_bins=n_bins)
    p, t = data()
    if p.ndim == 1:
        p[:3] = 1.0  # confidences of exactly 1 land in the last sliver
    update(jm, tm, p, t)
    assert_same_figures(tm.plot_reliability_diagram(), jm.plot_reliability_diagram())


def test_retrieval_curve_plots_equal_the_jax_package():
    p, t = RNG.random(N).astype(np.float32), RNG.integers(0, 2, N).astype(np.int64)
    idx = RNG.integers(0, 6, N).astype(np.int64)
    jm, tm = pair("RetrievalPrecisionRecallCurve", max_k=5)
    update(jm, tm, p, t, indexes=idx)
    assert_same_figures(tm.plot(), jm.plot())
    jm, tm = pair("RetrievalRecallAtFixedPrecision", min_precision=0.3)
    update(jm, tm, p, t, indexes=idx)
    assert_same_figures(tm.plot(), jm.plot())


@pytest.mark.parametrize("name, args, data", [
    ("BinaryAUROC", (), _binary),
    ("MulticlassAveragePrecision", (4,), _multiclass),
    ("BinaryRecallAtFixedPrecision", (0.5,), _binary),
])
def test_a_scalar_subclass_of_a_curve_class_plots_its_value(name, args, data):
    # deliberate deviation: the JAX package's curve plot raises on such a value
    jm, tm = pair(name, *args)
    update(jm, tm, *data())
    with pytest.raises((IndexError, TypeError)):
        jm.plot()
    value = jm.compute()
    value = value[0] if isinstance(value, tuple) else value
    assert_same_figures(tm.plot(), metrics_tpu.core.metric.Metric.plot(jm, value))


# ------------------------------------------------------------------ helpers


def test_grid_split_and_trim_equal_the_jax_package():
    for n in range(1, 17):
        assert tplot._get_col_row_split(n) == jplot._get_col_row_split(n)
    _, axs = plt.subplots(2, 3)
    assert len(tplot.trim_axs(axs, 4)) == 4
    one = plt.subplots()[1]
    assert tplot.trim_axs(one, 1) is one


def test_plot_helpers_take_tensors_as_the_jax_ones_take_arrays():
    vals = RNG.random((4, 3)).astype(np.float32)
    assert_same_figures(tplot.plot_single_or_multi_val(list(torch.from_numpy(vals)), legend_name="c", name="m",
                                                       lower_bound=0.0, upper_bound=1.0, higher_is_better=True),
                        jplot.plot_single_or_multi_val(list(jnp.asarray(vals)), legend_name="c", name="m",
                                                       lower_bound=0.0, upper_bound=1.0, higher_is_better=True))
    series = [{"a": torch.tensor(0.1 * i), "b": torch.tensor(0.2 * i)} for i in range(3)]
    jseries = [{"a": jnp.asarray(0.1 * i), "b": jnp.asarray(0.2 * i)} for i in range(3)]
    assert_same_figures(tplot.plot_single_or_multi_val(series), jplot.plot_single_or_multi_val(jseries))
    bf16 = torch.tensor([0.25, 0.5], dtype=torch.bfloat16)
    assert_same_figures(tplot.plot_single_or_multi_val(bf16), jplot.plot_single_or_multi_val(np.array([0.25, 0.5])))
    with pytest.raises(ValueError, match="Got empty sequence"):
        tplot.plot_single_or_multi_val([])
    with pytest.raises(ValueError, match="Expected 2 or 3 elements in curve object"):
        tplot.plot_curve((torch.zeros(3),))
    with pytest.raises(ValueError, match="to match number of labels in confmat"):
        tplot.plot_confusion_matrix(torch.zeros(3, 3, dtype=torch.int64), labels=["a"])
    with pytest.raises(ValueError, match="array of 3 matplotlib axis objects"):
        tplot.plot_confusion_matrix(torch.zeros(3, 2, 2, dtype=torch.int64), ax=plt.subplots()[1])


def test_without_matplotlib_the_jax_error_is_raised(monkeypatch):
    monkeypatch.setattr(timports, "_MATPLOTLIB_AVAILABLE", False)
    monkeypatch.setattr(jplot, "_MATPLOTLIB_AVAILABLE", False)
    jm, tm = pair("BinaryAccuracy")
    update(jm, tm, *_binary())
    with pytest.raises(ModuleNotFoundError) as want:
        jm.plot()
    for call in (tm.plot, lambda: tplot.plot_curve((torch.zeros(2), torch.zeros(2))),
                 lambda: tplot.plot_confusion_matrix(torch.eye(2)),
                 lambda: tplot.plot_reliability_diagram(torch.zeros(2), torch.zeros(2))):
        with pytest.raises(ModuleNotFoundError) as got:
            call()
        assert str(got.value) == str(want.value)
    assert jimports._MATPLOTLIB_AVAILABLE  # the flag of the JAX module itself is untouched


def test_the_smokes_stand_in_pyplot_records_what_matplotlib_draws(monkeypatch):
    # the card's machine has no matplotlib: chip_smoke.py holds the card's plots against
    # the CPU's through a recording stand-in of the pyplot calls the port makes
    import sys

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    g = torch.Generator().manual_seed(3)
    batches = [{"probs": torch.randn(256, 10, generator=g).softmax(-1), "labels": torch.randint(0, 10, (256,), generator=g),
                "scores": torch.rand(256, generator=g), "binary": torch.randint(0, 2, (256,), generator=g)}
               for _ in range(3)]
    with chip_smoke.plot_backend(np) as backend:
        assert backend.startswith("matplotlib")
        drawn = chip_smoke.plot_metrics(torch, batches, "cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setattr(timports, "_MATPLOTLIB_AVAILABLE", False)
    with chip_smoke.plot_backend(np) as backend:
        assert backend.startswith("stand-in")
        recorded = chip_smoke.plot_metrics(torch, batches, "cpu")
    assert not timports._MATPLOTLIB_AVAILABLE
    assert set(drawn) == set(recorded)
    for name in drawn:
        for got, want in zip(recorded[name], drawn[name]):
            if got["labels"][3] == []:  # matplotlib's own tick labels, where the port sets none
                want["labels"][3] = []
        assert chip_smoke.plot_err(np, name, recorded[name], drawn[name]) == 0.0
