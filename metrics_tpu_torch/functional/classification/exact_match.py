"""Exact match (subset accuracy) functionals (counterpart of
``metrics_tpu/functional/classification/exact_match.py``)."""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _as_inputs,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """Per-sample "every position right" (samplewise) or their count, and the number
    of samples (1 for samplewise)."""
    if ignore_index is not None:
        preds = torch.where(target == ignore_index, ignore_index, preds)
    correct = (preds == target).sum(dim=1) == preds.shape[1]
    correct = correct if multidim_average == "samplewise" else correct.sum()
    total = torch.full((), preds.shape[0] if multidim_average == "global" else 1, device=preds.device)
    return correct, total


def _multilabel_exact_match_update(
    preds: Tensor, target: Tensor, num_labels: int, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor]:
    if multidim_average == "global":
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
        target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    correct = ((preds == target).sum(dim=1) == num_labels).sum(dim=-1)
    total = torch.full((), preds.shape[0 if multidim_average == "global" else 2], device=preds.device)
    return correct, total


def multiclass_exact_match(
    preds, target, num_classes: int, multidim_average: str = "global", ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    """Share of samples whose every position is predicted right (``samplewise``: per sample)."""
    preds, target = _as_inputs(preds, target, device)
    top_k, average = 1, None
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def multilabel_exact_match(
    preds, target, num_labels: int, threshold: float = 0.5, multidim_average: str = "global",
    ignore_index: Optional[int] = None, validate_args: bool = True, device=None,
) -> Tensor:
    """Share of samples whose every label is predicted right."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds, target, task: str, num_classes: Optional[int] = None, num_labels: Optional[int] = None,
    threshold: float = 0.5, multidim_average: str = "global", ignore_index: Optional[int] = None,
    validate_args: bool = True, device=None,
) -> Tensor:
    """Task dispatcher (multiclass or multilabel)."""
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTaskNoBinary.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_exact_match(
            preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
