"""Pearson's contingency coefficient functionals (counterpart of
``metrics_tpu/functional/nominal/pearson.py``)."""
from typing import Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.nominal.utils import (
    _format_and_densify,
    _nominal_confmat,
    _nominal_input_validation,
    _pair_matrix,
    _pair_tables,
    _pearsons_values,
)
from metrics_tpu_torch.ops.confmat import confusion_counts
from metrics_tpu_torch.utils.data import to_tensor


def _pearsons_contingency_coefficient_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> Tensor:
    """The ``(C, C)`` int64 contingency table of one batch."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    """Pearson's contingency coefficient of one table (float64 on its device, float32 out)."""
    return _pearsons_values(confmat[None])[0].float()


def pearsons_contingency_coefficient(
    preds,
    target,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Pearson's contingency coefficient between two categorical series.
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds, target, num_classes = _format_and_densify(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confusion_counts(preds, target, None, num_classes))


def pearsons_contingency_coefficient_matrix(
    matrix,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Pearson's contingency coefficient between all pairs of columns: ``(V, V)`` float32."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    tables, pairs, num_variables = _pair_tables(matrix, nan_strategy, nan_replace_value, device)
    values = _pearsons_values(tables)
    return _pair_matrix(num_variables, pairs, values, values, tables.device)
