"""Plots of metric values, curves, confusion matrices and reliability diagrams
(counterpart of ``metrics_tpu/utils/plot.py``).

matplotlib is imported inside each function, and a missing one raises the JAX
package's ``ModuleNotFoundError``. Values may be tensors on any device, numpy arrays,
Python numbers, or sequences and dicts of them: each tensor goes to the host once
(``.detach().cpu()``), with one host read for each plotted value.
"""
from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils import imports

_PLOT_OUT_TYPE = Tuple[Any, Any]


def _error_on_missing_matplotlib() -> None:
    if not imports._MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Please install with `pip install matplotlib`"
        )


def _to_np(v: Any) -> np.ndarray:
    """``v`` on the host: one device-to-host read for a tensor (bfloat16 as float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def plot_single_or_multi_val(
    val: Union[Any, Sequence[Any], Dict[str, Any], Sequence[Dict[str, Any]]],
    ax: Optional[Any] = None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Plot scalar or per-class values, or a time series of them.

    A single value plots its element(s) as points; a dict plots one labelled point
    (or series) per key; a sequence is a series of values over steps. Optional bound
    lines and a higher/lower-is-better label annotate the figure.
    """
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots() if ax is None else (None, ax)
    ax.get_xaxis().set_visible(False)

    if isinstance(val, dict):
        for i, (k, v) in enumerate(val.items()):
            v = _to_np(v)
            if v.size != 1:
                ax.plot(v, marker="o", markersize=10, linestyle="-", label=k)
                ax.get_xaxis().set_visible(True)
                ax.set_xlabel("Step")
                ax.set_xticks(np.arange(v.size))
            else:
                ax.plot(i, v.reshape(()), marker="o", markersize=10, label=k)
    elif isinstance(val, (list, tuple)):
        n_steps = len(val)
        if n_steps == 0:
            raise ValueError("Got empty sequence for argument `val`.")
        if isinstance(val[0], dict):
            series = {k: np.stack([_to_np(step[k]) for step in val]) for k in val[0]}
            for k, v in series.items():
                ax.plot(v, marker="o", markersize=10, linestyle="-", label=k)
        else:
            stacked = np.stack([_to_np(v) for v in val], 0)
            multi_series = stacked.ndim != 1
            rows = stacked.T if multi_series else stacked[None, :]
            for i, v in enumerate(rows):
                label = (f"{legend_name} {i}" if legend_name else f"{i}") if multi_series else ""
                ax.plot(v, marker="o", markersize=10, linestyle="-", label=label)
        ax.get_xaxis().set_visible(True)
        ax.set_xlabel("Step")
        ax.set_xticks(np.arange(n_steps))
    else:
        arr = _to_np(val)
        if arr.size == 1:
            ax.plot([arr.reshape(())], marker="o", markersize=10)
        else:
            for i, v in enumerate(arr):
                label = f"{legend_name} {i}" if legend_name else f"{i}"
                ax.plot(i, v, marker="o", markersize=10, linestyle="None", label=label)

    handles, labels = ax.get_legend_handles_labels()
    if handles and labels:
        ax.legend(loc="center left", bbox_to_anchor=(1, 0.5))

    ylim = ax.get_ylim()
    if lower_bound is not None and upper_bound is not None and (lower_bound <= ylim[0] or upper_bound >= ylim[1]):
        factor = 0.1 * (upper_bound - lower_bound)
        ax.set_ylim(
            bottom=lower_bound - factor if ylim[0] < lower_bound else ylim[0] - factor,
            top=upper_bound + factor if ylim[1] > upper_bound else ylim[1] + factor,
        )

    ax.grid(True)
    ax.set_ylabel(name or None)

    if higher_is_better is not None:
        xlim = ax.get_xlim()
        factor = 0.1 * (xlim[1] - xlim[0])
        y_ = [lower_bound, upper_bound] if lower_bound is not None and upper_bound is not None else ylim
        if higher_is_better:
            ax.set_xlim(xlim[0] - factor, xlim[1])
            ax.text(xlim[0], y_[1], s="Higher is better", rotation=90, ha="center", va="top", fontsize=10)
        else:
            ax.set_xlim(xlim[0], xlim[1] + factor)
            ax.text(xlim[1] + factor, y_[1], s="Lower is better", rotation=90, ha="center", va="top", fontsize=10)
    return fig, ax


def _get_col_row_split(n: int) -> Tuple[int, int]:
    """Smallest near-square (rows, cols) grid covering n plots."""
    nsq = np.sqrt(n)
    if int(nsq) ** 2 == n:
        return int(nsq), int(nsq)
    if int(np.floor(nsq)) * int(np.ceil(nsq)) >= n:
        return int(np.floor(nsq)), int(np.ceil(nsq))
    return int(np.ceil(nsq)), int(np.ceil(nsq))


def trim_axs(axs: Any, nb: int) -> Any:
    """Trim excess axes from a grid so it holds exactly nb subplots."""
    if isinstance(axs, np.ndarray):
        axs = axs.flat
    else:
        return axs
    for ax in axs[nb:]:
        ax.remove()
    return axs[:nb]


def plot_confusion_matrix(
    confmat: Any,
    ax: Optional[Any] = None,
    add_text: bool = True,
    labels: Optional[List[Union[int, str]]] = None,
    cmap: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Heatmap(s) of an ``[N, N]`` (binary/multiclass) or ``[N, 2, 2]`` (multilabel)
    confusion matrix: rows (true class) on y, columns (predicted class) on x."""
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    confmat = _to_np(confmat)
    if confmat.ndim == 3:  # multilabel
        nb, n_classes = confmat.shape[0], 2
        rows, cols = _get_col_row_split(nb)
    else:
        nb, n_classes, rows, cols = 1, confmat.shape[0], 1, 1

    if labels is not None and confmat.ndim != 3 and len(labels) != n_classes:
        raise ValueError(
            "Expected number of elements in arg `labels` to match number of labels in confmat but "
            f"got {len(labels)} and {n_classes}"
        )
    if confmat.ndim == 3:
        fig_label: Optional[Sequence] = labels if labels is not None else np.arange(nb)
        labels = list(map(str, range(n_classes)))
    else:
        fig_label = None
        labels = labels if labels is not None else np.arange(n_classes).tolist()

    if ax is not None and nb > 1 and not isinstance(ax, np.ndarray):
        raise ValueError(
            f"Expected argument `ax` to be an array of {nb} matplotlib axis objects for a multilabel"
            " confusion matrix, but got a single axis."
        )
    if ax is None:
        fig, axs = plt.subplots(nrows=rows, ncols=cols)
    else:
        fig, axs = (ax.flat[0] if isinstance(ax, np.ndarray) else ax).get_figure(), ax
    axs = trim_axs(axs, nb)
    for i in range(nb):
        ax_i = axs[i] if rows != 1 or cols != 1 else axs
        if fig_label is not None:
            ax_i.set_title(f"Label {fig_label[i]}", fontsize=15)
        ax_i.imshow(confmat[i] if confmat.ndim == 3 else confmat, cmap=cmap)
        ax_i.set_xlabel("Predicted class", fontsize=15)
        ax_i.set_ylabel("True class", fontsize=15)
        ax_i.set_xticks(list(range(n_classes)))
        ax_i.set_yticks(list(range(n_classes)))
        ax_i.set_xticklabels(labels, rotation=45, fontsize=10)
        ax_i.set_yticklabels(labels, rotation=25, fontsize=10)
        if add_text:
            for ii, jj in product(range(n_classes), range(n_classes)):
                v = confmat[i, ii, jj] if confmat.ndim == 3 else confmat[ii, jj]
                txt = f"{v.item():.3g}" if np.issubdtype(confmat.dtype, np.floating) else str(v.item())
                ax_i.text(jj, ii, txt, ha="center", va="center", fontsize=15)
    return fig, axs


def plot_curve(
    curve: Tuple[Any, Any, Any],
    score: Optional[Any] = None,
    ax: Optional[Any] = None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Plot an (x, y, thresholds) curve, PR or ROC style, single or per class."""
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    _error_msg = (
        "Expected 2 or 3 elements in curve object, but got {}. Make sure that the metric that returns the"
        " curve object has been called with the correct arguments."
    )
    if len(curve) < 2:
        raise ValueError(_error_msg.format(len(curve)))
    x, y = curve[:2]
    scores = None if score is None else _to_np(score).reshape(-1)

    fig, ax = plt.subplots() if ax is None else (None, ax)
    if isinstance(x, (list, tuple)) or x.ndim > 1:  # per-class curves
        for i, (x_i, y_i) in enumerate(zip(x, y)):
            label = f"{legend_name}_{i}" if legend_name else str(i)
            if scores is not None:
                label += f" AUC={scores[i]:0.3f}"
            ax.plot(_to_np(x_i), _to_np(y_i), linestyle="-", linewidth=2, label=label)
        ax.legend()
    else:
        label = f"AUC={scores.item():0.3f}" if scores is not None else None
        ax.plot(_to_np(x), _to_np(y), linestyle="-", linewidth=2, label=label)
        if label is not None:
            ax.legend()
    ax.grid(True)
    if label_names is not None:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name is not None:
        ax.set_title(name)
    return fig, ax


def plot_reliability_diagram(
    confidences: Any,
    accuracies: Any,
    n_bins: int = 15,
    ax: Optional[Any] = None,
    name: Optional[str] = None,
) -> _PLOT_OUT_TYPE:
    """Reliability diagram of a calibration metric: each bin's mean accuracy against
    the identity diagonal, the |accuracy - confidence| gaps that the ECE sums, and a
    strip of the samples' density. The bins are the uniform [0, 1] bins of the
    calibration compute, with a last sliver at 1.0 for confidences of exactly 1.
    """
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    conf = _to_np(confidences).reshape(-1)
    acc = _to_np(accuracies).reshape(-1).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ids = np.clip(np.searchsorted(edges, conf, side="right") - 1, 0, n_bins)
    n_buckets = n_bins + 1
    bin_acc = np.zeros(n_buckets)
    bin_conf = np.zeros(n_buckets)
    bin_count = np.bincount(ids, minlength=n_buckets).astype(np.float64)
    np.add.at(bin_acc, ids, acc)
    np.add.at(bin_conf, ids, conf)
    nonzero = bin_count > 0
    bin_acc[nonzero] /= bin_count[nonzero]
    bin_conf[nonzero] /= bin_count[nonzero]

    fig, ax = plt.subplots() if ax is None else (None, ax)
    width = 1.0 / n_bins
    centers = np.concatenate([(edges[:-1] + edges[1:]) / 2, [1.0 + width / 4]])
    widths = np.concatenate([np.full(n_bins, width * 0.9), [width * 0.45]])
    ax.bar(centers, np.where(nonzero, bin_acc, 0.0), width=widths, label="accuracy", alpha=0.8)
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=1, color="gray", label="perfect calibration")
    for c, a, cf, nz in zip(centers, bin_acc, bin_conf, nonzero):
        if nz:
            ax.plot([c, c], [a, cf], color="tab:red", linewidth=2, alpha=0.7)
    frac = bin_count / max(bin_count.sum(), 1.0)
    ax.bar(centers, frac * 0.1, width=widths, bottom=-0.12, color="tab:gray", alpha=0.6)
    ax.set_xlim(0.0, 1.0 + (width / 2 if nonzero[-1] else 0.0))
    ax.set_ylim(-0.13, 1.0)
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper left")
    if name is not None:
        ax.set_title(name)
    return fig, ax
