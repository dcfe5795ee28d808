"""Multilabel ranking functionals (counterpart of
``metrics_tpu/functional/classification/ranking.py``): coverage error, label-ranking
average precision and ranking loss.

The same math as the JAX package, in plain torch ops: ranks with ties as pairwise
comparison counts over the label axis (``rank(x_j) = #{k : x_k <= x_j}``, an
``(N, C, C)`` compare, built ``_PAIRWISE_ROWS`` samples at a time so that a large
batch does not materialise it whole) and the ranking loss from a double stable
argsort under the JAX package's sort order (its float comparator, through
:func:`metrics_tpu_torch.ops.rank.descending_sort_key`).
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.ops.rank import descending_sort_key

#: samples per chunk of the (N, C, C) pairwise compare: 2^26 elements at C = 80
_PAIRWISE_ROWS = 1 << 13


def _rank_data(x: Tensor) -> Tensor:
    """Ranks of a 1-D tensor, ties resolved to the largest rank of their group."""
    return (x[None, :] <= x[:, None]).sum(dim=1)


def _ranking_reduce(score: Tensor, n_elements) -> Tensor:
    return score / n_elements


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(f"Expected preds tensor to be floating point, but received input with dtype {preds.dtype}")


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """Summed coverage (labels ranked at or above the lowest-scored relevant one) and the sample count."""
    offset = torch.where(target == 0, torch.abs(preds.min()) + 10, 0.0)
    preds_min = (preds + offset).min(dim=1).values
    coverage = (preds >= preds_min[:, None]).sum(dim=1).to(torch.float32)
    return coverage.sum(), coverage.numel()


def multilabel_coverage_error(
    preds,
    target,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Multilabel coverage error."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    return _ranking_reduce(*_multilabel_coverage_error_update(preds, target))


def _label_ranking_ap_rows(neg_preds: Tensor, relevant: Tensor) -> Tensor:
    """Each sample's label-ranking AP: over its relevant labels, the mean of (rank among
    the relevant labels) / (rank among all labels), ranks of ``-preds`` with ties at the top."""
    le = neg_preds[:, None, :] <= neg_preds[:, :, None]  # le[i, j, k]: x_k <= x_j
    rank_all = le.sum(dim=2).to(torch.float32)
    rank_rel = (le & relevant[:, None, :]).sum(dim=2).to(torch.float32)
    n_labels = relevant.shape[1]
    n_relevant = relevant.sum(dim=1)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    score = torch.where(n_relevant > 0, per_label.sum(dim=1) / torch.clamp(n_relevant, min=1), 1.0)
    return torch.where((n_relevant > 0) & (n_relevant < n_labels), score, 1.0)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """Summed label-ranking AP (1.0 for a sample with no or only relevant labels) and the sample count."""
    neg_preds, relevant = -preds, target == 1
    rows = [
        _label_ranking_ap_rows(neg_preds[s:s + _PAIRWISE_ROWS], relevant[s:s + _PAIRWISE_ROWS])
        for s in range(0, preds.shape[0], _PAIRWISE_ROWS)
    ]
    return torch.cat(rows).sum(), preds.shape[0]


def multilabel_ranking_average_precision(
    preds,
    target,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Label-ranking average precision of multilabel data."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    return _ranking_reduce(*_multilabel_ranking_average_precision_update(preds, target))


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    """Summed label-ranking loss (0 for a sample with no or only relevant labels) and the sample count."""
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)
    mask = (n_relevant > 0) & (n_relevant < n_labels)
    # ascending stable order as the JAX package's sort makes it: the descending key of -preds
    order = torch.argsort(descending_sort_key(-preds), dim=1, stable=True)
    inverse = torch.argsort(order, dim=1, stable=True)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / torch.clamp(denom, min=1)
    return torch.where(mask, loss, 0.0).sum(), n_preds


def multilabel_ranking_loss(
    preds,
    target,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Label ranking loss of multilabel data."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    return _ranking_reduce(*_multilabel_ranking_loss_update(preds, target))
