"""RetrievalPrecisionRecallCurve and RetrievalRecallAtFixedPrecision (counterpart of
``metrics_tpu/retrieval/precision_recall_curve.py``).

Every query at once: a stable sort by (query, descending score), within-query ranks
from the query run lengths, one scatter into a ``(num_queries, max_k)`` relevance
matrix and one cumulative sum along k. The JAX package runs this in numpy on the
host; here it runs on the metric's device, with one host read (the query count
and the largest query, which set the output's shape).
"""
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs
from metrics_tpu_torch.utils.data import dim_zero_cat


def _retrieval_recall_at_fixed_precision(
    precision: Tensor, recall: Tensor, top_k: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    """Largest recall whose precision is at least ``min_precision``, with its k.

    Ties on recall go to the larger k; with no such point, or a best recall of 0,
    k is ``len(top_k)``.
    """
    qualifying = [
        (r, k) for p, r, k in zip(precision.tolist(), recall.tolist(), top_k.tolist()) if p >= min_precision
    ]
    n = len(top_k)
    if not qualifying:
        return torch.tensor(0.0, dtype=torch.float32), torch.tensor(n, dtype=torch.int32)
    max_recall, best_k = max(qualifying)
    if max_recall == 0.0:
        best_k = n
    return torch.tensor(max_recall, dtype=torch.float32), torch.tensor(int(best_k), dtype=torch.int32)


class RetrievalPrecisionRecallCurve(Metric):
    r"""Mean precision and recall over queries at every cutoff k = 1..max_k.

    Args:
        max_k: largest cutoff (default: the size of the largest query).
        adaptive_k: cap each query's denominators at its document count.
        empty_target_action: ``neg`` (0s) / ``pos`` (1s) / ``skip`` / ``error`` for
            queries without positives.
        ignore_index: drop documents whose target equals this value.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 0, 1, 1, 1])
        >>> preds = torch.tensor([0.4, 0.01, 0.5, 0.6, 0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, False, True, True, False, True])
        >>> r = RetrievalPrecisionRecallCurve(max_k=4, device="cpu")
        >>> precisions, recalls, top_k = r(preds, target, indexes=indexes)
        >>> precisions
        tensor([1.0000, 0.5000, 0.6667, 0.5000])
        >>> recalls
        tensor([0.5000, 0.5000, 1.0000, 1.0000])
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    # curve-valued compute: per-query top-k curves are assembled with host reads (the JAX class declares it too)
    _host_side_compute = True

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False
        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if (max_k is not None) and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k
        self.validate_args = validate_args

        self.add_state("indexes", default=[], dist_reduce_fx="cat", cat_dtype=torch.int32, cat_fill_value=-1)
        self.add_state("preds", default=[], dist_reduce_fx="cat", cat_dtype=torch.float32)
        self.add_state("target", default=[], dist_reduce_fx="cat", cat_dtype=torch.int32)

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

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        indexes, preds, target = dim_zero_cat(self.indexes), dim_zero_cat(self.preds), dim_zero_cat(self.target)
        keep = indexes >= 0  # CatBuffer fill rows
        indexes, preds, target = indexes[keep], preds[keep], target[keep]

        # queries contiguous, scores descending within a query, ties in row order
        # (+ 0.0 makes -0.0 equal to 0.0 for a radix sort, as numpy compares them)
        order = torch.sort(-preds + 0.0, stable=True).indices
        order = order[torch.sort(indexes[order], stable=True).indices]
        indexes, target = indexes[order], target[order]
        _, inverse, counts = torch.unique_consecutive(indexes, return_inverse=True, return_counts=True)
        num_queries = counts.numel()
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(indexes.numel(), device=indexes.device) - starts[inverse]
        max_k = self.max_k if self.max_k is not None else (int(counts.max()) if num_queries else 1)

        rel = torch.zeros((num_queries, max_k), dtype=torch.float32, device=indexes.device)
        in_k = rank < max_k
        rel[inverse[in_k], rank[in_k]] = target[in_k].to(torch.float32)
        rel_cum = torch.cumsum(rel, 1)
        n_pos = torch.zeros(num_queries, dtype=torch.float32, device=indexes.device)
        n_pos.index_add_(0, inverse, target.to(torch.float32))

        denom = torch.arange(1, max_k + 1, dtype=torch.float32, device=indexes.device)[None, :]
        if self.adaptive_k:
            denom = torch.minimum(denom, counts[:, None].to(torch.float32))
        precision = rel_cum / denom
        recall = rel_cum / n_pos.clamp_min(1.0)[:, None]

        empty = n_pos == 0
        keep_q = torch.ones(num_queries, dtype=torch.bool, device=indexes.device)
        if self.empty_target_action == "error":
            if bool(empty.any()):
                raise ValueError("`compute` method was provided with a query with no positive target.")
        elif self.empty_target_action == "skip":
            keep_q = ~empty
        else:  # "pos" / "neg"
            fill = 1.0 if self.empty_target_action == "pos" else 0.0
            precision[empty] = fill
            recall[empty] = fill

        if bool(keep_q.any()):
            precision_mean, recall_mean = precision[keep_q].mean(0), recall[keep_q].mean(0)
        else:
            precision_mean = recall_mean = torch.zeros(max_k, dtype=torch.float32, device=indexes.device)
        return precision_mean, recall_mean, torch.arange(1, max_k + 1, dtype=torch.int32, device=indexes.device)

    def plot(self, curve: Optional[Tuple[Tensor, Tensor, Tensor]] = None, ax: Optional[Any] = None):
        """Plot the mean precision against recall over the cutoffs k = 1..max_k
        (``compute()`` by default). Returns ``(figure, axis)``."""
        from metrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        precisions, recalls = curve[0], curve[1]
        return plot_curve(
            (recalls, precisions, curve[2]),
            ax=ax,
            label_names=("Recall", "Precision"),
            name=self.__class__.__name__,
        )


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """Largest recall at a minimum precision over the k = 1..max_k curve, with its k.

    Args:
        min_precision: precision floor in [0, 1].
        max_k / adaptive_k / empty_target_action / ignore_index: see
            :class:`RetrievalPrecisionRecallCurve`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 0, 1, 1, 1])
        >>> preds = torch.tensor([0.4, 0.01, 0.5, 0.6, 0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, False, True, True, False, True])
        >>> r = RetrievalRecallAtFixedPrecision(min_precision=0.8, device="cpu")
        >>> r(preds, target, indexes=indexes)
        (tensor(0.5000), tensor(1, dtype=torch.int32))
    """

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k,
            adaptive_k=adaptive_k,
            empty_target_action=empty_target_action,
            ignore_index=ignore_index,
            **kwargs,
        )
        if not isinstance(min_precision, float) or not 0.0 <= min_precision <= 1.0:
            raise ValueError("`min_precision` has to be a float value in range [0, 1]")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:  # type: ignore[override]
        precision, recall, top_k = super().compute()
        return tuple(
            t.to(precision.device)
            for t in _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
        )

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None):
        """Plot the best recall (the first element of ``compute()``) as
        :meth:`Metric.plot` does. Returns ``(figure, axis)``."""
        val = val if val is not None else self.compute()[0]
        return Metric.plot(self, val, ax)
