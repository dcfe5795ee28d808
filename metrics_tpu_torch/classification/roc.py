"""ROC metric classes (counterpart of ``metrics_tpu/classification/roc.py``): the
precision-recall curve's state classes with ROC computes."""
from typing import Any, List, Optional, Tuple, Union

from torch import Tensor

from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from metrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from metrics_tpu_torch.utils.enums import ClassificationTask


class _ROCPlotMixin:
    """The curve plot of the three ROC tasks (in place of the PR curve's)."""

    def plot(self, curve=None, score=None, ax=None):
        """Plot the ROC curve (``compute()`` by default). Returns ``(figure, axis)``."""
        from metrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(
            curve, score=score, ax=ax,
            label_names=("False positive rate", "True positive rate"),
            name=self.__class__.__name__,
        )


class BinaryROC(_ROCPlotMixin, BinaryPrecisionRecallCurve):
    """Binary ROC: ``(fpr, tpr, thresholds)``."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_roc_compute(self._curve_state(), self.thresholds)


class MulticlassROC(_ROCPlotMixin, MulticlassPrecisionRecallCurve):
    """Multiclass ROC, one-vs-rest per class."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        return _multiclass_roc_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelROC(_ROCPlotMixin, MultilabelPrecisionRecallCurve):
    """Multilabel ROC, one per label."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        return _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self.ignore_index)


class ROC:
    """Task dispatcher."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassROC(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelROC(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
