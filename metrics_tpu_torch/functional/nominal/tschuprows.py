"""Tschuprow's T functionals (counterpart of ``metrics_tpu/functional/nominal/tschuprows.py``)."""
from typing import Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.nominal.utils import (
    _tschuprows_t_values,
    _format_and_densify,
    _nominal_confmat,
    _nominal_input_validation,
    _pair_matrix,
    _pair_tables,
    _single,
    _warn_failed_pairs,
)
from metrics_tpu_torch.ops.confmat import confusion_counts
from metrics_tpu_torch.utils.data import to_tensor


def _tschuprows_t_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> Tensor:
    """The ``(C, C)`` int64 contingency table of one batch."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Tschuprow's T of one contingency table (float64 on its device, float32 out)."""
    return _single(_tschuprows_t_values(confmat[None], bias_correction), "Tschuprow's T")


def tschuprows_t(
    preds,
    target,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Tschuprow's T statistic of association between two categorical series.
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds, target, num_classes = _format_and_densify(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confusion_counts(preds, target, None, num_classes), bias_correction)


def tschuprows_t_matrix(
    matrix,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Tschuprow's T between all pairs of columns of an ``(N, V)`` matrix: ``(V, V)`` float32."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    tables, pairs, num_variables = _pair_tables(matrix, nan_strategy, nan_replace_value, device)
    values, failed = _tschuprows_t_values(tables, bias_correction)
    _warn_failed_pairs(failed, "Tschuprow's T")
    return _pair_matrix(num_variables, pairs, values, values, tables.device)
