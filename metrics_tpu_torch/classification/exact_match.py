"""Exact match metric classes (counterpart of ``metrics_tpu/classification/exact_match.py``).

States: ``correct`` (an int64 ``sum`` count, or with ``multidim_average="samplewise"``
a ``cat`` list of per-sample bools) and ``total``, the number of samples.

Repair of the JAX package: in samplewise mode ``total`` is 1 (each sample counts
alone), but the JAX classes reduce it by ``sum``, so a ``forward`` after the first
and a sync over k processes turn it into 2 and k, and divide every per-sample
value by them. Here it is reduced by ``max``, which keeps it at 1.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from metrics_tpu_torch.utils.data import _count_dtype, dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


class _ExactMatchBase(Metric):
    """Shared states, accumulation and compute."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _create_state(self) -> None:
        if self.multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat", cat_dtype=torch.bool)
            self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="max")
        else:
            self.add_state("correct", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=_count_dtype()), dist_reduce_fx="sum")

    def _accumulate(self, correct: Tensor, total: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.correct.append(correct)
            self.total = total.to(_count_dtype())
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def compute(self) -> Tensor:
        correct = dim_zero_cat(self.correct) if isinstance(self.correct, list) else self.correct
        return _exact_match_reduce(correct, self.total)


class MulticlassExactMatch(_ExactMatchBase):
    """Multiclass exact match: a sample counts when every position is right."""

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        top_k, average = 1, None
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        self._accumulate(*_multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index))


class MultilabelExactMatch(_ExactMatchBase):
    """Multilabel exact match: a sample counts when every label is right."""

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self._accumulate(*_multilabel_exact_match_update(preds, target, self.num_labels, self.multidim_average))


class ExactMatch:
    """Task dispatcher: ``ExactMatch(task=...)`` returns the multiclass or multilabel class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if task == ClassificationTaskNoBinary.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelExactMatch(num_labels, threshold, **kwargs)
        raise ValueError(f"Not handled value: {task}")
