"""Average precision metric classes (counterpart of
``metrics_tpu/classification/average_precision.py``). With ``tolerance > 0`` (JAX
:44-45, 79-80, 115-119) ``compute`` serves the certified bracket midpoint of the
sketch tier's histogram states, NaN for a lane without positives."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auroc import _reduce_scores
from metrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_arg_validation,
    _multilabel_average_precision_compute,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Binary average precision; NaN when there is no positive."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _sketch_computable: bool = True

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            return self._sketch_scores("ap", "binary_ap")[0]
        return _binary_average_precision_compute(self._curve_state(), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Multiclass average precision, one-vs-rest per class, then ``average``."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"
    _sketch_computable: bool = True

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            res, pos = self._sketch_scores("ap", "multiclass_ap")
            return _reduce_scores(res, self.average, weights=pos)
        return _multiclass_average_precision_compute(
            self._curve_state(), self.num_classes, self.average, self.thresholds
        )


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Multilabel average precision, one per label, then ``average`` (``micro`` flattens)."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"
    _sketch_computable: bool = True

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            if self.average == "micro":  # the summed lanes are the micro flatten
                return self._sketch_scores("ap", "multilabel_ap", micro=True)[0]
            res, pos = self._sketch_scores("ap", "multilabel_ap")
            return _reduce_scores(res, self.average, weights=pos)
        return _multilabel_average_precision_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AveragePrecision:
    """Task dispatcher."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassAveragePrecision(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelAveragePrecision(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
