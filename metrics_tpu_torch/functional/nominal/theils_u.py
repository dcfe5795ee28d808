"""Theil's U functionals (counterpart of ``metrics_tpu/functional/nominal/theils_u.py``)."""
from typing import Optional, Union

from torch import Tensor

from metrics_tpu_torch.functional.nominal.utils import (
    _format_and_densify,
    _nominal_confmat,
    _nominal_input_validation,
    _pair_matrix,
    _pair_tables,
    _theils_u_values,
)
from metrics_tpu_torch.ops.confmat import confusion_counts
from metrics_tpu_torch.utils.data import to_tensor


def _theils_u_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> Tensor:
    """The ``(C, C)`` int64 contingency table of one batch."""
    return _nominal_confmat(preds, target, num_classes, nan_strategy, nan_replace_value)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """Theil's U of one table ``[target, preds]`` (float64 on its device, float32 out)."""
    return _theils_u_values(confmat[None])[0].float()


def theils_u(
    preds,
    target,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Theil's U (uncertainty coefficient) between two categorical series.

    Asymmetric: ``theils_u(preds, target) != theils_u(target, preds)`` in general.
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    preds, target, num_classes = _format_and_densify(preds, target, nan_strategy, nan_replace_value)
    return _theils_u_compute(confusion_counts(preds, target, None, num_classes))


def theils_u_matrix(
    matrix,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
    device=None,
) -> Tensor:
    """Theil's U between all pairs of columns, asymmetric: ``out[i, j]`` from the table of
    pair ``(i, j)`` (column ``i`` as ``preds``), ``out[j, i]`` from its transpose."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    tables, pairs, num_variables = _pair_tables(matrix, nan_strategy, nan_replace_value, device)
    upper = _theils_u_values(tables)
    lower = _theils_u_values(tables.transpose(1, 2))
    return _pair_matrix(num_variables, pairs, upper, lower, tables.device)
