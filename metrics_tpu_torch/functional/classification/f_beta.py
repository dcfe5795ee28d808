"""F-beta / F1 functionals (counterpart of ``metrics_tpu/functional/classification/f_beta.py``)."""
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


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
) -> Tensor:
    beta2 = beta**2
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp, fn, fp = _sum_axis(tp, axis), _sum_axis(fn, axis), _sum_axis(fp, axis)
    score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    if average in ("binary", "micro"):
        return score
    return _weighted_average(score, tp, fn, average)


def _check_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def _binary_fbeta_score_arg_validation(
    beta: float, threshold: float = 0.5, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> None:
    _check_beta(beta)
    _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)


def _multiclass_fbeta_score_arg_validation(
    beta: float,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_beta(beta)
    _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)


def _multilabel_fbeta_score_arg_validation(
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_beta(beta)
    _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)


def binary_fbeta_score(
    preds, target, beta: float, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_fbeta_score_arg_validation(beta, threshold, multidim_average, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average)


def multiclass_fbeta_score(
    preds, target, beta: float, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_fbeta_score_arg_validation(beta, num_classes, top_k, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average)


def multilabel_fbeta_score(
    preds, target, beta: float, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_fbeta_score_arg_validation(beta, num_labels, threshold, average, multidim_average, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average)


def binary_f1_score(
    preds, target, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args, device)


def multiclass_f1_score(
    preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
    )


def multilabel_f1_score(
    preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
    multidim_average: str = "global", ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
    )


def fbeta_score(
    preds, target, task: str, beta: float = 1.0, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
    top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_fbeta_score(
            preds, target, beta, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_fbeta_score(
            preds, target, beta, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")


def f1_score(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
    top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher."""
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, device,
    )
