"""Stat scores (tp/fp/tn/fn), the shared core of the classification metrics.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py`` with the same
three multiclass regimes:

- samplewise or ``top_k > 1``: one-hot comparison sums (:305-337);
- micro average: one fused compare-and-count (:342-352, and the argmax form of
  :385-402 for float ``(N, C, ...)`` inputs);
- macro, weighted and none averages: the confusion matrix of
  :func:`metrics_tpu_torch.ops.confmat.confusion_counts` (:358-364), one histogram
  kernel launch per update on the card.

Ignored positions are masked out of the counts (no boolean indexing), and logits
become probabilities with a branch-free ``torch.where`` so that no update waits on
the device. Counts are int64.

Public functions take ``device``: a tensor input stays on its device, any other
array-like goes to ``device`` (``cuda`` by default).
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.confmat import confusion_counts
from metrics_tpu_torch.ops.streaming import argmax_correct_count, eq_count
from metrics_tpu_torch.utils.checks import _check_same_shape, _is_concrete
from metrics_tpu_torch.utils.data import _count_dtype, _one_hot, select_topk, to_tensor
from metrics_tpu_torch.utils.enums import ClassificationTask


def _sigmoid_if_logits(preds: Tensor) -> Tensor:
    """Apply sigmoid iff any value is outside [0, 1], without a host round trip."""
    is_prob = torch.all((preds >= 0) & (preds <= 1))
    return torch.where(is_prob, preds, torch.sigmoid(preds))


def _softmax_if_logits(preds: Tensor, dim: int = 1) -> Tensor:
    """Apply softmax along ``dim`` iff any value is outside [0, 1], without a host round trip."""
    is_prob = torch.all((preds >= 0) & (preds <= 1))
    return torch.where(is_prob, preds, torch.softmax(preds, dim=dim))


def _as_inputs(preds, target, device) -> Tuple[Tensor, Tensor]:
    preds = to_tensor(preds, device)
    return preds, to_tensor(target, preds.device)


def _check_binary_values(preds: Tensor, target: Tensor, ignore_index: Optional[int], what: str) -> None:
    if not _is_concrete(preds, target):
        return
    unique_values = torch.unique(target)
    allowed = (unique_values == 0) | (unique_values == 1)
    if ignore_index is not None:
        allowed = allowed | (unique_values == ignore_index)
    if not bool(torch.all(allowed)):
        raise RuntimeError(
            f"Detected the following values in `target`: {unique_values.tolist()} but expected only"
            f" the following values {[0, 1] if ignore_index is None else [0, 1, ignore_index]}."
        )
    if not preds.is_floating_point():
        unique_values = torch.unique(preds)
        if not bool(torch.all((unique_values == 0) | (unique_values == 1))):
            raise RuntimeError(
                f"Detected the following values in `preds`: {unique_values.tolist()} but expected only"
                f" the following values [0,1] since {what} is a label tensor."
            )


# ----------------------------------------------------------------------- binary


def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Expected input to be atleast 2D when multidim_average is set to `samplewise`")
    _check_binary_values(preds, target, ignore_index, "`preds`")


def _binary_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Probability/logit -> {0,1} labels; ignored positions -> target=-1 (masked)."""
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    preds = preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn counts; -1 targets fall out of every predicate."""
    sum_dim = (0, 1) if multidim_average == "global" else 1
    tp = ((target == preds) & (target == 1)).sum(sum_dim).squeeze()
    fn = ((target != preds) & (target == 1)).sum(sum_dim).squeeze()
    fp = ((target != preds) & (target == 0)).sum(sum_dim).squeeze()
    tn = ((target == preds) & (target == 0)).sum(sum_dim).squeeze()
    return tp, fp, tn, fn


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if multidim_average == "global" else 1).squeeze()


def binary_stat_scores(
    preds,
    target,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """tp/fp/tn/fn/support for binary tasks ``(..., 5)``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# -------------------------------------------------------------------- multiclass


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) or top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should "
                " atleast 3D when multidim_average is set to `samplewise`"
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError(
                "When `preds` and `target` have the same shape, the shape of `preds` should "
                " atleast 2D when multidim_average is set to `samplewise`"
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    _check_multiclass_values(preds, target, num_classes, ignore_index)


def _check_multiclass_values(preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]) -> None:
    if not _is_concrete(preds, target):
        return
    num_unique_values = torch.unique(target).numel()
    check = num_unique_values > num_classes if ignore_index is None else num_unique_values > num_classes + 1
    if check:
        raise RuntimeError(
            "Detected more unique values in `target` than `num_classes`. Expected only"
            f" {num_classes if ignore_index is None else num_classes + 1} but found"
            f" {num_unique_values} in `target`."
        )
    if not preds.is_floating_point():
        num_unique_values = torch.unique(preds).numel()
        if num_unique_values > num_classes:
            raise RuntimeError(
                "Detected more unique values in `preds` than `num_classes`. Expected only"
                f" {num_classes} but found {num_unique_values} in `preds`."
            )


def _multiclass_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    top_k: int = 1,
) -> Tuple[Tensor, Tensor]:
    """Argmax probabilities to labels (when top_k==1); flatten extra dims."""
    if preds.ndim == target.ndim + 1 and top_k == 1:
        preds = preds.argmax(dim=1)
    preds = preds.reshape(*preds.shape[:2], -1) if top_k != 1 else preds.reshape(preds.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    return preds, target


def _micro_counts_from_tp(
    tp: Tensor, n_valid: Tensor, num_classes: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Derive fp/fn/tn from the fused tp count (micro average), all int64.

    tn = C*n - ... can exceed int32 for a single large update, hence the count dtype.
    """
    cd = _count_dtype()
    fp = n_valid.to(cd) - tp
    fn = fp
    tn = num_classes * n_valid.to(cd) - (fp + fn + tp)
    return tp, fp, tn, fn


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Samplewise / top_k>1: one-hot sums; micro: masked eq-sums; else the confusion matrix."""
    if multidim_average == "samplewise" or top_k != 1:
        ignore_in = 0 <= ignore_index <= num_classes - 1 if ignore_index is not None else None
        aug = ignore_index is not None and not ignore_in
        if aug:
            # out-of-range ignore_index: remap ignored positions to extra class C
            ignored = target == ignore_index
            target = torch.where(ignored, num_classes, target)
            if preds.ndim == target.ndim:  # label preds (top_k == 1 path)
                preds = torch.where(ignored, num_classes, preds)

        n_extra = 1 if aug else 0
        if top_k > 1:
            preds_oh = torch.movedim(select_topk(preds, topk=top_k, dim=1), 1, -1)
        else:
            preds_oh = _one_hot(preds, num_classes + n_extra)
        target_oh = _one_hot(target, num_classes + n_extra)

        if ignore_index is not None:
            if ignore_in:
                mask = (target == ignore_index).unsqueeze(-1)
            else:
                if top_k == 1:
                    preds_oh = preds_oh[..., :-1]
                target_oh = target_oh[..., :-1]
                mask = (target == num_classes).unsqueeze(-1)
            target_oh = torch.where(mask, -1, target_oh)

        sum_dim = (0, 1) if multidim_average == "global" else (1,)
        tp = ((target_oh == preds_oh) & (target_oh == 1)).sum(sum_dim)
        fn = ((target_oh != preds_oh) & (target_oh == 1)).sum(sum_dim)
        fp = ((target_oh != preds_oh) & (target_oh == 0)).sum(sum_dim)
        tn = ((target_oh == preds_oh) & (target_oh == 0)).sum(sum_dim)
        return tp, fp, tn, fn

    preds = preds.reshape(-1)
    target = target.reshape(-1)

    if average == "micro":
        if ignore_index is None:
            tp = eq_count(preds, target)
            n_valid = torch.full((), target.numel(), dtype=_count_dtype(), device=target.device)
            return _micro_counts_from_tp(tp, n_valid, num_classes)
        valid = target != ignore_index
        tp = ((preds == target) & valid).sum()
        return _micro_counts_from_tp(tp, valid.sum(), num_classes)

    # out-of-range labels are clipped into [0, C-1] by confusion_counts rather than
    # raising; validate_args catches bad labels
    valid = None if ignore_index is None else target != ignore_index
    confmat = confusion_counts(preds, target, valid, num_classes)
    tp = torch.diag(confmat)
    fp = confmat.sum(0) - tp
    fn = confmat.sum(1) - tp
    tn = confmat.sum() - (fp + fn + tp)
    return tp, fp, tn, fn


def _multiclass_stat_scores_format_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Format + update in one call; float ``(N, C, ...)`` preds with a micro, top-1,
    global average count through one argmax-compare-count."""
    fused = (
        preds.ndim == target.ndim + 1
        and top_k == 1
        and average == "micro"
        and multidim_average == "global"
        and preds.is_floating_point()
    )
    if fused:
        probs = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
        flat_t = target.reshape(-1)
        if ignore_index is None:
            tp = argmax_correct_count(probs, flat_t)
            n_valid = torch.full((), flat_t.numel(), dtype=_count_dtype(), device=flat_t.device)
            return _micro_counts_from_tp(tp, n_valid, num_classes)
        valid = flat_t != ignore_index
        tp = argmax_correct_count(probs, flat_t, valid)
        return _micro_counts_from_tp(tp, valid.sum(), num_classes)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    return _multiclass_stat_scores_update(preds, target, num_classes, top_k, average, multidim_average, ignore_index)


def _multiclass_stat_scores_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim) if res.ndim > 1 else res
    if average == "macro":
        return res.to(torch.float32).mean(sum_dim)
    if average == "weighted":
        weight = (tp + fn).to(torch.float32)
        if multidim_average == "global":
            return (res * (weight / weight.sum()).reshape(*weight.shape, 1)).sum(sum_dim)
        return (res * (weight / weight.sum(-1, keepdim=True)).reshape(*weight.shape, 1)).sum(sum_dim)
    if average is None or average == "none":
        return res
    return None


def multiclass_stat_scores(
    preds,
    target,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """tp/fp/tn/fn/support for multiclass tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    tp, fp, tn, fn = _multiclass_stat_scores_format_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# -------------------------------------------------------------------- multilabel


def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Expected input to be atleast 3D when multidim_average is set to `samplewise`")
    _check_binary_values(preds, target, ignore_index, "preds")


def _multilabel_stat_scores_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    if preds.is_floating_point():
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    preds = preds.reshape(*preds.shape[:2], -1)
    target = target.reshape(*target.shape[:2], -1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multilabel_stat_scores_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    sum_dim = (0, -1) if multidim_average == "global" else (-1,)
    tp = ((target == preds) & (target == 1)).sum(sum_dim).squeeze()
    fn = ((target != preds) & (target == 1)).sum(sum_dim).squeeze()
    fp = ((target != preds) & (target == 0)).sum(sum_dim).squeeze()
    tn = ((target == preds) & (target == 0)).sum(sum_dim).squeeze()
    return tp, fp, tn, fn


def _multilabel_stat_scores_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tensor:
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    sum_dim = 0 if multidim_average == "global" else 1
    if average == "micro":
        return res.sum(sum_dim)
    if average == "macro":
        return res.to(torch.float32).mean(sum_dim)
    if average == "weighted":
        w = (tp + fn).to(torch.float32)
        return (res * (w / w.sum()).reshape(*w.shape, 1)).sum(sum_dim)
    if average is None or average == "none":
        return res
    return None


def multilabel_stat_scores(
    preds,
    target,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """tp/fp/tn/fn/support for multilabel tasks."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


# ------------------------------------------------------- shared pipelines
# (tensor-validate -> format -> update; shared by every stat-score-derived metric,
# which differ only in their reduce formula)


def _binary_stat_scores_pipeline(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if validate_args:
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    return _binary_stat_scores_update(preds, target, multidim_average)


def _multiclass_stat_scores_pipeline(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str],
    top_k: int,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if validate_args:
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    return _multiclass_stat_scores_format_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )


def _multilabel_stat_scores_pipeline(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if validate_args:
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    return _multilabel_stat_scores_update(preds, target, multidim_average)


# -------------------------------------------------------------------- dispatcher


def stat_scores(
    preds,
    target,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: Optional[str] = "global",
    top_k: Optional[int] = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tensor:
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
