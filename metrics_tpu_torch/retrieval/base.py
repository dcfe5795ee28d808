"""RetrievalMetric base (counterpart of ``metrics_tpu/retrieval/base.py``).

Cat states ``indexes`` / ``preds`` / ``target``; ``compute`` evaluates every query
in one pass of :func:`~metrics_tpu_torch.ops.segment.grouped_retrieval_scores` (one
sort, the fused segment-scan passes, no per-query host loop), then reduces over the
valid queries by ``empty_target_action`` (``neg`` / ``pos`` / ``skip`` / ``error``).

With ``cat_capacity`` the states are ``CatBuffer``s whose unused rows hold index -1,
an invalid query: a full buffer goes to the kernel as it is. The JAX package pads
every compute to a power of two, so that a growing state compiles at most log2(N)
programs, and takes the whole buffer once it is at least half full; eager PyTorch
compiles nothing, so the port pads nothing and takes the whole buffer only when it
is full, where it is the valid rows themselves, or under a trace (the JAX package's
traced branch).

Host syncs: ``empty_target_action="error"`` reads one flag; nothing else in
``compute`` does (a ``CatBuffer`` knows its count on the host).
"""
from abc import ABC
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.ops.segment import grouped_retrieval_scores
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs, _is_concrete
from metrics_tpu_torch.utils.data import dim_zero_cat


class RetrievalMetric(Metric, ABC):
    """Base class of the retrieval metrics.

    Subclasses set ``_grouped_metric`` (a metric of ``grouped_retrieval_scores``) and
    pass their options through ``_metric_kwargs``.
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    _grouped_metric: str = ""
    allow_non_binary_target: bool = False
    # fall-out's empty queries are the ones without NEGATIVE targets
    _empty_refers_to_negatives: bool = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.validate_args = validate_args
        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        # unused CatBuffer rows carry index -1: an invalid query for the segment pass
        self.add_state("indexes", default=[], dist_reduce_fx="cat", cat_dtype=torch.int32, cat_fill_value=-1)
        self.add_state("preds", default=[], dist_reduce_fx="cat", cat_dtype=torch.float32)
        self.add_state(
            "target",
            default=[],
            dist_reduce_fx="cat",
            cat_dtype=torch.float32 if self.allow_non_binary_target else torch.int32,
        )

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes,
            preds,
            target,
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
            validate_args=self.validate_args,
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _metric_kwargs(self) -> dict:
        return {}

    def compute(self) -> Tensor:
        if isinstance(self.indexes, CatBuffer) and (
            self.indexes.valid_count() == self.indexes.capacity or not _is_concrete(self.indexes.data)
        ):
            # a full buffer is its own valid rows (its overflow warned in the wrapper); under a
            # trace the whole buffer goes, as in the JAX package: unused rows are invalid queries
            indexes, preds, target = self.indexes.data, self.preds.data, self.target.data
        else:
            indexes, preds, target = dim_zero_cat(self.indexes), dim_zero_cat(self.preds), dim_zero_cat(self.target)
        scores, n_pos, valid = grouped_retrieval_scores(
            indexes, preds, target, self._grouped_metric, **self._metric_kwargs()
        )
        return _reduce_retrieval_scores(
            scores, n_pos, valid, self.empty_target_action, self._empty_refers_to_negatives
        )


def _reduce_retrieval_scores(
    scores: Tensor, n_pos: Tensor, valid: Tensor, empty_action: str, empty_refers_to_negatives: bool = False
) -> Tensor:
    """Mean of the valid queries' scores, empty queries handled by ``empty_action``
    (the JAX package's ``_dense_retrieval_compute_jit``, eager)."""
    empty = valid & (n_pos == 0)
    if empty_action == "error":
        if bool(empty.any()):
            kind = "negative" if empty_refers_to_negatives else "positive"
            raise ValueError(f"`compute` method was provided with a query with no {kind} target.")
        keep = valid
    elif empty_action == "skip":
        keep = valid & ~empty
    elif empty_action == "pos":
        scores = torch.where(empty, 1.0, scores)
        keep = valid
    else:  # "neg"
        scores = torch.where(empty, 0.0, scores)
        keep = valid
    n_keep = keep.sum()
    total = torch.where(keep, scores, 0.0).sum()
    return torch.where(n_keep > 0, total / n_keep.clamp_min(1), 0.0).to(torch.float32)
