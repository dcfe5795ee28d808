"""Precision / recall functionals (counterpart of ``metrics_tpu/functional/classification/precision_recall.py``)."""
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


def _precision_recall_reduce(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, different_stat = _sum_axis(tp, axis), _sum_axis(different_stat, axis)
        return _safe_divide(tp, tp + different_stat)
    return _weighted_average(_safe_divide(tp, tp + different_stat), tp, fn, average)


def _binary(stat, preds, target, threshold, multidim_average, ignore_index, validate_args, device) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce(stat, tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def _multiclass(
    stat, preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def _multilabel(
    stat, preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def binary_precision(
    preds, target, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _binary("precision", preds, target, threshold, multidim_average, ignore_index, validate_args, device)


def multiclass_precision(
    preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _multiclass(
        "precision", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
    )


def multilabel_precision(
    preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _multilabel(
        "precision", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
    )


def binary_recall(
    preds, target, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _binary("recall", preds, target, threshold, multidim_average, ignore_index, validate_args, device)


def multiclass_recall(
    preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _multiclass(
        "recall", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
    )


def multilabel_recall(
    preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return _multilabel(
        "recall", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
    )


def _dispatch(
    stat, preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
    ignore_index, validate_args, device,
) -> Tensor:
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return _binary(stat, preds, target, threshold, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return _multiclass(
            stat, preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return _multilabel(
            stat, preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")


def precision(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
    top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    return _dispatch(
        "precision", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, device,
    )


def recall(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
    top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    return _dispatch(
        "recall", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, device,
    )
