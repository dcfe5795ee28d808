"""Shared helpers of the nominal-association metrics (counterpart of
``metrics_tpu/functional/nominal/utils.py``).

Contingency tables are int64 counts from the histogram kernel. The statistics are
computed in float64 on the tables' device, for a batch of tables at once: an ``(P, R,
K)`` stack, each table padded with zeros. The JAX package drops a table's empty rows
and columns on the host (``_drop_empty_rows_and_cols``); here they are masked on the
device instead, which gives the same value: an empty row or column adds nothing to a
sum, and the statistics count only the rows and columns that are kept.

Under a trace (a capture, ``torch.func.vmap``) the label check is skipped and
``nan_strategy="drop"`` raises ``ValueError``, as the JAX package's traced branches do.
"""
import itertools
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.confmat import confusion_counts, pair_confusion_counts
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.data import to_tensor
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[Union[int, float]]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (int, float)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tuple[Tensor, Tensor]:
    """The rows and columns of each ``(..., R, K)`` table that are kept (not all zero),
    as ``(..., R)`` and ``(..., K)`` bool masks on the table's device."""
    return confmat.sum(-1) > 0, confmat.sum(-2) > 0


def _table_parts(confmat: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The float64 tables, their row sums, column sums and totals, and the masks of the
    kept rows and columns, of an ``(P, R, K)`` stack of int64 tables."""
    cm = confmat.to(torch.float64)
    rows, cols = _drop_empty_rows_and_cols(cm)
    row_sums, col_sums = cm.sum(2), cm.sum(1)
    return cm, row_sums, col_sums, row_sums.sum(1), rows, cols


def _compute_chi_squared(parts: Tuple[Tensor, ...], bias_correction: bool) -> Tensor:
    """Chi-squared independence statistic of each table of a stack (its
    :func:`_table_parts`), with Yates' correction where a table has one degree of freedom
    and ``bias_correction``."""
    cm, row_sums, col_sums, total, rows, cols = parts
    expected = row_sums[:, :, None] * col_sums[:, None, :] / total[:, None, None]
    kept = rows[:, :, None] & cols[:, None, :]
    df = ((rows.sum(1) - 1) * (cols.sum(1) - 1))[:, None, None]
    if bias_correction:
        diff = expected - cm
        yates = cm + torch.sign(diff) * torch.clamp(diff.abs(), max=0.5)
        cm = torch.where(df == 1, yates, cm)
    terms = torch.where(kept, (cm - expected) ** 2 / torch.where(kept, expected, 1.0), 0.0)
    return torch.where(df[:, 0, 0] == 0, 0.0, terms.sum((1, 2)))


def _compute_bias_corrected_values(
    phi_squared: Tensor, n_rows: Tensor, n_cols: Tensor, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    phi_squared_corrected = torch.clamp(phi_squared - (n_rows - 1) * (n_cols - 1) / (confmat_sum - 1), min=0.0)
    rows_corrected = n_rows - (n_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = n_cols - (n_cols - 1) ** 2 / (confmat_sum - 1)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _phi_squared(confmat: Tensor, bias_correction: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """phi^2 of each ``(P, R, K)`` table with its total and kept row and column counts (float64)."""
    parts = _table_parts(confmat)
    total, rows, cols = parts[3:]
    chi_squared = _compute_chi_squared(parts, bias_correction)
    return chi_squared / total, total, rows.sum(1).to(torch.float64), cols.sum(1).to(torch.float64)


def _phi_association_values(
    confmat: Tensor, bias_correction: bool, denominator: Callable[[Tensor, Tensor], Tensor]
) -> Tuple[Tensor, Tensor]:
    """sqrt(phi^2 / denominator(rows - 1, cols - 1)) of each ``(P, R, K)`` table (float64),
    bias-corrected or not, and where bias correction failed: Cramer's V and Tschuprow's T."""
    phi_squared, total, n_rows, n_cols = _phi_squared(confmat, bias_correction)
    if bias_correction:
        phi_c, rows_c, cols_c = _compute_bias_corrected_values(phi_squared, n_rows, n_cols, total)
        failed = torch.minimum(rows_c, cols_c) == 1
        value = torch.where(failed, torch.nan, torch.sqrt(phi_c / denominator(rows_c - 1, cols_c - 1)))
    else:
        failed = torch.zeros_like(total, dtype=torch.bool)
        value = torch.sqrt(phi_squared / denominator(n_rows - 1, n_cols - 1))
    return torch.clamp(value, 0.0, 1.0), failed


def _cramers_v_values(confmat: Tensor, bias_correction: bool) -> Tuple[Tensor, Tensor]:
    """Cramer's V of each ``(P, R, K)`` table (float64) and where bias correction failed."""
    return _phi_association_values(confmat, bias_correction, torch.minimum)


def _tschuprows_t_values(confmat: Tensor, bias_correction: bool) -> Tuple[Tensor, Tensor]:
    """Tschuprow's T of each ``(P, R, K)`` table (float64) and where bias correction failed."""
    return _phi_association_values(confmat, bias_correction, lambda r, k: torch.sqrt(r * k))


def _pearsons_values(confmat: Tensor) -> Tensor:
    """Pearson's contingency coefficient of each ``(P, R, K)`` table (float64)."""
    phi_squared = _phi_squared(confmat, bias_correction=False)[0]
    return torch.clamp(torch.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0)


def _theils_u_values(confmat: Tensor) -> Tensor:
    """Theil's U of each ``(P, R, K)`` table indexed ``[target, preds]`` (float64):
    the share of the entropy of ``preds`` (the columns) that the rows explain."""
    cm, row_sums, col_sums, total, _, cols = _table_parts(confmat)
    p_xy = cm / total[:, None, None]
    p_y = (row_sums / total[:, None])[:, :, None]
    # cells with no count add nothing (the JAX package's nansum of 0 * log(p_y / 0))
    s_xy = torch.where(cm > 0, p_xy * torch.log(p_y / torch.where(cm > 0, p_xy, 1.0)), 0.0).sum((1, 2))
    p_x = col_sums / total[:, None]
    s_x = -torch.where(cols, p_x * torch.log(torch.where(cols, p_x, 1.0)), 0.0).sum(1)
    return torch.where(s_x == 0, 0.0, (s_x - s_xy) / torch.where(s_x == 0, 1.0, s_x))


def _single(values_and_failed: Tuple[Tensor, Tensor], metric_name: str) -> Tensor:
    """The one value of a one-table batch as a float32 scalar, warning (one read) where
    bias correction failed."""
    value, failed = values_and_failed
    if bool(failed[0]):
        _unable_to_use_bias_correction_warning(metric_name=metric_name)
    return value[0].to(torch.float32)


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """NaN replaced (``keep`` None) or marked: ``keep`` is False on the rows where
    either input is NaN, which the callers drop. Nothing leaves the device."""
    if nan_strategy == "replace":
        return torch.nan_to_num(preds, nan=nan_replace_value), torch.nan_to_num(target, nan=nan_replace_value), None
    if not _is_concrete(preds, target):
        # the JAX package's traced branch: dropping rows by content has no static shape
        raise ValueError(
            "`nan_strategy='drop'` removes rows by data content and cannot run under"
            " jit/shard_map; use nan_strategy='replace' or drop NaN rows on host"
            " before updating."
        )
    keep = ~(torch.isnan(preds) | torch.isnan(target))
    return preds, target, keep


def _argmax_2d(x: Tensor) -> Tensor:
    return x.argmax(1) if x.ndim == 2 else x


def _format_and_densify(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str,
    nan_replace_value: Optional[Union[int, float]],
) -> Tuple[Tensor, Tensor, int]:
    """Inputs as dense 0-based labels over their joint label set, in the labels' order.

    The JAX package runs ``np.unique`` on the host; here ``torch.unique`` runs on the
    inputs' device (its one read is the number of labels). Rows with a NaN are
    removed under ``nan_strategy="drop"``.
    """
    preds, target = _argmax_2d(preds), _argmax_2d(target)
    preds, target, keep = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    p, t = preds.reshape(-1), target.reshape(-1)
    if keep is not None:
        p, t = p[keep.reshape(-1)], t[keep.reshape(-1)]
    uniq, inverse = torch.unique(torch.cat([p, t]), return_inverse=True)
    return inverse[: p.numel()], inverse[p.numel():], max(uniq.numel(), 1)


def _densify_columns(
    matrix: Tensor, nan_strategy: str, nan_replace_value: Optional[Union[int, float]]
) -> Tuple[Tensor, Optional[Tensor], list]:
    """Each column of an ``(N, V)`` matrix as dense 0-based ids over its own labels, in
    the labels' order: one sort of each column, a scan of the label changes, and one
    read of the ``V`` label counts. Both run along the last dimension of the ``(V, N)``
    transpose: on the card PyTorch's scan along the long outer dimension of a narrow
    tensor is slow (it took most of the device time of a ``_matrix`` call).

    Returns ``(ids, valid, cardinalities)``, ``ids`` an ``(N, V)`` view. Under
    ``nan_strategy="drop"`` ``valid`` is False where an entry is NaN (its id is
    meaningless), else None.
    """
    if matrix.dtype == torch.bool:
        matrix = matrix.to(torch.uint8)
    valid = None
    if nan_strategy == "replace":
        matrix = torch.nan_to_num(matrix, nan=nan_replace_value)
    elif matrix.is_floating_point():
        valid = ~torch.isnan(matrix)
    values, order = torch.sort(matrix.T.contiguous(), dim=1)  # NaN sorts last; -0.0 and 0.0 are one label
    new = torch.ones_like(values, dtype=torch.bool)
    new[:, 1:] = values[:, 1:] != values[:, :-1]
    rank = torch.cumsum(new, dim=1) - 1
    ids = torch.empty_like(rank).scatter_(1, order, rank)
    distinct = new if valid is None else new & ~torch.isnan(values)
    return ids.T, valid, distinct.sum(1).tolist()


def _nominal_confmat(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> Tensor:
    """The ``(C, C)`` int64 table ``[target, preds]`` of one update of a nominal class:
    2-D inputs argmaxed, NaN handled, labels checked with one read, one histogram
    launch (count mode; mask mode with dropped rows)."""
    preds, target = _argmax_2d(preds), _argmax_2d(target)
    preds, target, keep = _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)
    if keep is not None:
        preds, target = torch.where(keep, preds, 0), torch.where(keep, target, 0)
    _validate_dense_labels(preds, target, num_classes)
    return confusion_counts(preds.to(torch.int64), target.to(torch.int64), keep, num_classes)


def _validate_dense_labels(preds: Tensor, target: Tensor, num_classes: int) -> None:
    """Raise on labels outside ``[0, num_classes)``: one ``aminmax`` over both inputs and
    one read of its two values; skipped under a trace, as in the JAX package."""
    if preds.numel() == 0 or target.numel() == 0 or not _is_concrete(preds, target):
        return
    both = torch.cat([preds.reshape(-1), target.reshape(-1)])
    if both.dtype == torch.bool:
        both = both.to(torch.uint8)
    lo, hi = torch.stack(torch.aminmax(both)).tolist()
    if lo < 0 or hi >= num_classes:
        raise ValueError(
            f"Nominal metrics expect dense 0-based labels in [0, {num_classes}), but got values "
            f"in [{lo}, {hi}]. Remap labels first (e.g. np.unique(..., return_inverse=True)) "
            "or construct the metric with a larger `num_classes`."
        )


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )


def _pair_tables(
    matrix, nan_strategy: str, nan_replace_value: Optional[Union[int, float]], device
) -> Tuple[Tensor, List[Tuple[int, int]], int]:
    """The contingency tables of every column pair of an ``(N, V)`` matrix, one table per
    pair of ``itertools.combinations`` (``[column j, column i]`` for ``(i, j)``), all
    counted in one histogram launch (:func:`pair_confusion_counts`) after each column
    is densified once."""
    matrix = to_tensor(matrix, device)
    num_variables = matrix.shape[1]
    pairs = list(itertools.combinations(range(num_variables), 2))
    ids, valid, cardinalities = _densify_columns(matrix, nan_strategy, nan_replace_value)
    return pair_confusion_counts(ids, pairs, cardinalities, valid), pairs, num_variables


def _pair_matrix(
    num_variables: int, pairs: List[Tuple[int, int]], upper: Tensor, lower: Tensor, device: torch.device
) -> Tensor:
    """``(V, V)`` float32 with ones on the diagonal, ``upper[p]`` at ``(i, j)`` and
    ``lower[p]`` at ``(j, i)`` of pair ``p = (i, j)``."""
    out = torch.ones((num_variables, num_variables), dtype=torch.float64, device=device)
    if pairs:
        i, j = torch.tensor(pairs, device=device).T
        out[i, j] = upper
        out[j, i] = lower
    return out.to(torch.float32)


def _warn_failed_pairs(failed: Tensor, metric_name: str) -> None:
    """One warning per pair whose bias correction failed: one read of the flags."""
    for flag in failed.tolist():
        if flag:
            _unable_to_use_bias_correction_warning(metric_name=metric_name)
