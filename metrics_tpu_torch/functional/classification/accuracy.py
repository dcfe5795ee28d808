"""Accuracy functionals (counterpart of ``metrics_tpu/functional/classification/accuracy.py``)."""
from typing import Optional

import torch
from torch import Tensor

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


def _sum_axis(x: Tensor, axis: int) -> Tensor:
    return x.sum(dim=axis) if x.ndim > axis else x


def _weighted_average(score: Tensor, tp: Tensor, fn: Tensor, average: Optional[str]) -> Tensor:
    """Per-class scores reduced by ``average`` (None/"none" keeps them)."""
    if average is None or average == "none":
        return score
    weights = (tp + fn).to(score.dtype) if average == "weighted" else torch.ones_like(score)
    return _safe_divide(weights * score, weights.sum(-1, keepdim=True)).sum(-1)


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> Tensor:
    """Reduce stat scores into accuracy."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, fn = _sum_axis(tp, axis), _sum_axis(fn, axis)
        if multilabel:
            fp, tn = _sum_axis(fp, axis), _sum_axis(tn, axis)
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _weighted_average(score, tp, fn, average)


def binary_accuracy(
    preds,
    target,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_accuracy(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_accuracy(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_accuracy(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_accuracy(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
