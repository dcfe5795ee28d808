"""AUROC functionals (counterpart of ``metrics_tpu/functional/classification/auroc.py``).

Exact mode (``thresholds=None``) runs the fixed-shape device kernels of
:mod:`metrics_tpu_torch.ops.clf_curve` (sort, cumsum, and the segmented-scan kernel
on the card); binned mode integrates the ROC of the confusion tensor.
``tolerance > 0`` lets the binary exact mode serve the sketch tier's certified
bracket midpoint when the bracket fits (``ops/clf_curve.py:_sketch_dispatch``).
"""
from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _is_confmat_state,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.ops.clf_curve import (
    binary_auroc_exact,
    mcclish_partial_auc,
    multiclass_auroc_exact,
    multilabel_auroc_exact,
)
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.compute import _auc_compute_without_check, _safe_divide
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _reduce_scores(res: Tensor, average: Optional[str], weights: Optional[Tensor]) -> Tensor:
    """NaN-dropping macro/weighted reduction of per-class scores."""
    if average is None or average == "none":
        return res
    nan = torch.isnan(res)
    if _is_concrete(res) and bool(nan.any()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    idx = ~nan
    if average == "macro":
        return torch.where(idx, res, 0.0).sum() / idx.sum()
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights.to(torch.float32), 0.0)
        weights = _safe_divide(weights, weights.sum())
        return torch.where(idx, res * weights, 0.0).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Per-class areas (NaN classes dropped from the average)."""
    if isinstance(fpr, Tensor):
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
    return _reduce_scores(res, average, weights)


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
    tolerance: float = 0.0,
    tolerance_bits: int = 12,
) -> Tensor:
    """Exact mode: the device kernel; binned: the ROC's area, McClish-corrected for ``max_fpr``."""
    if not _is_confmat_state(state):
        return binary_auroc_exact(
            state[0], state[1], max_fpr=max_fpr, tolerance=tolerance, tolerance_bits=tolerance_bits
        )
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1:
        return _auc_compute_without_check(fpr, tpr, 1.0)
    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    return mcclish_partial_auc(fpr, tpr, max_area)


def binary_auroc(
    preds,
    target,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    tolerance: float = 0.0,
    tolerance_bits: int = 12,
    device=None,
) -> Tensor:
    """Binary AUROC; ``max_fpr`` gives the McClish-standardized partial AUC."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_auroc_compute(state, thresholds, max_fpr, tolerance=tolerance, tolerance_bits=tolerance_bits)


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None), but got {average}"
        )


def _multiclass_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    """Exact mode: the binary kernel one-vs-rest per class."""
    if thresholds is None:
        res, pos = multiclass_auroc_exact(state[0], state[1])
        return _reduce_scores(res, average, weights=pos)
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=state[0][:, 1, :].sum(-1).to(torch.float32))


def multiclass_auroc(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Multiclass AUROC, one-vs-rest per class, then ``average``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_arg_validation(
    num_labels: int,
    average: Optional[str],
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )


def _multilabel_auroc_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Exact mode: the binary kernel per label; ``micro`` flattens all labels into one run."""
    if average == "micro":
        if _is_confmat_state(state) and thresholds is not None:
            return _binary_auroc_compute(state.sum(1), thresholds, max_fpr=None)
        return _binary_auroc_compute((state[0].reshape(-1), state[1].reshape(-1)), thresholds, max_fpr=None)

    if thresholds is None:
        res, pos = multilabel_auroc_exact(state[0], state[1])
        return _reduce_scores(res, average, weights=pos)
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_auroc(fpr, tpr, average, weights=state[0][:, 1, :].sum(-1).to(torch.float32))


def multilabel_auroc(
    preds,
    target,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Multilabel AUROC, one per label, then ``average``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds,
    target,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args, device=device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args, device)
    raise ValueError(f"Not handled value: {task}")
