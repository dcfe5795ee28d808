"""Dice functional (counterpart of ``metrics_tpu/functional/classification/dice.py``),
on the legacy input pipeline of :mod:`metrics_tpu_torch.functional.classification._legacy`."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification._legacy import (
    _input_squeeze,
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.functional.classification.stat_scores import _as_inputs
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """2 tp / (2 tp + fp + fn), reduced as ``average`` and ``mdmc_average`` say."""
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        keep = (tp + fp + fn) != 0
        numerator, denominator = numerator[keep], denominator[keep]
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # a class is absent when it has no true positive, false positive or false negative
        meaningless = (tp | fn | fp) == 0
        numerator = numerator.masked_fill(meaningless, -1)
        denominator = denominator.masked_fill(meaningless, -1)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds,
    target,
    zero_division: int = 0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    device=None,
) -> Tensor:
    """Dice score."""
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    allowed_mdmc_average = [None, "samplewise", "global"]
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    preds, target = _input_squeeze(*_as_inputs(preds, target, device))
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)
