"""Calibration error metric classes (counterpart of
``metrics_tpu/classification/calibration_error.py``).

States: ``confidences`` (float32) and ``accuracies`` (the binary target as int32,
or the multiclass top-1 correctness as float32), ``cat`` states, so that
``cat_capacity=N`` makes them preallocated ``CatBuffer``s. Each ``compute`` bins
them with three histogram launches on the card. Rows at ``ignore_index`` are
dropped at ``update``, as in the JAX package.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_tensor_validation,
    _binary_calibration_error_update,
    _ce_compute,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_tensor_validation,
    _multiclass_calibration_error_update,
)
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _multiclass_confusion_matrix_format,
)
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _CalibrationErrorBase(Metric):
    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _init_states(self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool,
                     accuracy_dtype: torch.dtype) -> None:
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confidences", [], dist_reduce_fx="cat", cat_dtype=torch.float32)
        self.add_state("accuracies", [], dist_reduce_fx="cat", cat_dtype=accuracy_dtype)

    def _append(self, preds: Tensor, target: Tensor, update_fn) -> None:
        if self.ignore_index is not None:
            keep = target >= 0
            preds, target = preds[keep], target[keep]
        confidences, accuracies = update_fn(preds, target)
        self.confidences.append(confidences.to(torch.float32))
        self.accuracies.append(accuracies.to(self._cat_meta["accuracies"][1]))

    def compute(self) -> Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.n_bins, norm=self.norm)

    def plot_reliability_diagram(self, ax: Optional[Any] = None):
        """Reliability diagram of the accumulated state: each bin's accuracy against its
        confidence, with the |accuracy - confidence| gaps that the ECE sums. Returns
        ``(figure, axis)``."""
        from metrics_tpu_torch.utils.plot import plot_reliability_diagram

        return plot_reliability_diagram(
            dim_zero_cat(self.confidences),
            dim_zero_cat(self.accuracies),
            n_bins=self.n_bins,
            ax=ax,
            name=self.__class__.__name__,
        )


class BinaryCalibrationError(_CalibrationErrorBase):
    """Binary expected calibration error (``norm="l1"``), RMS (``"l2"``) or maximum (``"max"``)."""

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self._init_states(n_bins, norm, ignore_index, validate_args, torch.int32)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(
            preds, target, threshold=0.0, ignore_index=self.ignore_index, convert_to_labels=False
        )
        self._append(preds, target, _binary_calibration_error_update)


class MulticlassCalibrationError(_CalibrationErrorBase):
    """Multiclass top-label calibration error (``norm`` as for the binary class)."""

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self._init_states(n_bins, norm, ignore_index, validate_args, torch.float32)

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_calibration_error_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(
            preds, target, ignore_index=self.ignore_index, convert_to_labels=False
        )
        self._append(preds, target, _multiclass_calibration_error_update)


class CalibrationError:
    """Task dispatcher."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassCalibrationError(num_classes, **kwargs)
        raise ValueError(f"Not handled value: {task}")
