"""Specificity functionals (counterpart of ``metrics_tpu/functional/classification/specificity.py``)."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.accuracy import _sum_axis, _weighted_average
from metrics_tpu_torch.functional.classification.stat_scores import (
    _as_inputs,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_pipeline,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_pipeline,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_pipeline,
)
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import ClassificationTask


def _specificity_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    """tn / (tn + fp), reduced by ``average``; the weights of ``weighted`` are tp + fn."""
    if average == "binary":
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tn, fp = _sum_axis(tn, axis), _sum_axis(fp, axis)
        return _safe_divide(tn, tn + fp)
    return _weighted_average(_safe_divide(tn, tn + fp), tp, fn, average)


def binary_specificity(
    preds, target, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_specificity(
    preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_specificity(
    preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
    )
    return _specificity_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def specificity(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
    top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_specificity(preds, target, threshold, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_specificity(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_specificity(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
