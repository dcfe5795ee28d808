"""AUROC metric classes (counterpart of ``metrics_tpu/classification/auroc.py``).

In exact mode each ``compute`` runs the device kernels of
:mod:`metrics_tpu_torch.ops.clf_curve`: one segmented-scan kernel launch per binary
run (per class or label in the one-vs-rest and per-label classes). With
``tolerance > 0`` (JAX :55-64, 108-109, 144-148) ``compute`` serves the certified
bracket midpoint of the sketch tier's histogram states instead.
"""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
    _reduce_scores,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.utils.enums import ClassificationTask


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary AUROC; ``max_fpr`` gives the McClish-standardized partial AUC."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _sketch_computable: bool = True

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        if self.tolerance > 0 and max_fpr is not None and max_fpr != 1:
            raise ValueError(
                "`tolerance > 0` certifies full-range AUROC only; partial-AUC `max_fpr` needs the exact tier."
            )
        self.max_fpr = max_fpr
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            return self._sketch_scores("auroc", "binary_auroc")[0]
        return _binary_auroc_compute(self._curve_state(), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Multiclass AUROC, one-vs-rest per class, then ``average``."""

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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            res, pos = self._sketch_scores("auroc", "multiclass_auroc")
            return _reduce_scores(res, self.average, weights=pos)
        return _multiclass_auroc_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Multilabel AUROC, one per label, then ``average`` (``micro`` flattens)."""

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
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        if self.tolerance > 0:
            if self.average == "micro":  # the summed lanes are the micro flatten
                return self._sketch_scores("auroc", "multilabel_auroc", micro=True)[0]
            res, pos = self._sketch_scores("auroc", "multilabel_auroc")
            return _reduce_scores(res, self.average, weights=pos)
        return _multilabel_auroc_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AUROC:
    """Task dispatcher."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassAUROC(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelAUROC(num_labels, average, **kwargs)
        raise ValueError(f"Not handled value: {task}")
