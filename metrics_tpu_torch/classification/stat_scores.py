"""Stat-scores metric classes (counterpart of ``metrics_tpu/classification/stat_scores.py``).

States are int64 ``sum`` tensors (global) or ``cat`` lists (samplewise).
"""
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_pipeline,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_pipeline,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_pipeline,
)
from metrics_tpu_torch.utils.data import _count_dtype, dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask


class _AbstractStatScores(Metric):
    """Shared tp/fp/tn/fn state machinery."""

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat", cat_dtype=_count_dtype())
            else:
                self.add_state(name, torch.zeros(size, dtype=_count_dtype()), dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for binary tasks."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("threshold", "multidim_average", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _binary_stat_scores_pipeline(
            preds, target, self.threshold, self.multidim_average, self.ignore_index, self.validate_args
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multiclass tasks."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_classes", "top_k", "average", "multidim_average", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(
            size=1 if (average == "micro" and top_k == 1) else num_classes, multidim_average=multidim_average
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
            preds, target, self.num_classes, self.average, self.top_k, self.multidim_average,
            self.ignore_index, self.validate_args,
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """tp/fp/tn/fn/support for multilabel tasks."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_labels", "threshold", "multidim_average", "ignore_index")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
            preds, target, self.num_labels, self.threshold, self.multidim_average, self.ignore_index,
            self.validate_args,
        )
        self._update_state(tp, fp, tn, fn)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


def _task_dispatch(task: str, binary, multiclass, multilabel, threshold, num_classes, num_labels, top_k, kwargs):
    """Construct the binary, multiclass or multilabel class of a task dispatcher.

    ``binary(threshold, **kwargs)``, ``multiclass(num_classes, top_k, **kwargs)`` and
    ``multilabel(num_labels, threshold, **kwargs)`` build the metric.
    """
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass(num_classes, top_k, **kwargs)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel(num_labels, threshold, **kwargs)
    raise ValueError(f"Not handled value: {task}")


class StatScores:
    """Task dispatcher: ``StatScores(task=...)`` returns the matching class."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_dispatch(
            task,
            BinaryStatScores,
            lambda c, k, **kw: MulticlassStatScores(c, k, average, **kw),
            lambda n, t, **kw: MultilabelStatScores(n, t, average, **kw),
            threshold, num_classes, num_labels, top_k, kwargs,
        )
