"""Precision-recall curve functionals: the shared state of the curve family.

Counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``.
Two state modes:

- ``thresholds=None`` (exact): the raw scores and targets; the curve has one point
  per distinct score, so its length depends on the data. :func:`_binary_clf_curve`
  builds it on the tensors' device with a stable descending sort, a cumsum and the
  indices where the sorted score changes (the JAX package runs the same steps in
  numpy on the host). The scalar AUROC/AP summaries do not take this path: they run
  the fixed-shape kernels of :mod:`metrics_tpu_torch.ops.clf_curve`.
- ``thresholds`` an int, list or tensor (binned): a ``(T, ..., 2, 2)`` confusion
  tensor from broadcast compares summed over the samples.

Under a trace (a capture, ``torch.func.vmap``, an engine's step) the exact curve
cannot have a data-dependent length: it is the static-shape padded curve of
:mod:`metrics_tpu_torch.ops.clf_curve`, the first ``K = (~isnan(thresholds)).sum()``
entries the eager curve, as the JAX package's traced branch; multiclass and
multilabel curves are one ``vmap`` of it over the columns.

Ignored targets become -1 and drop out of both modes. Public functions take
``device``: a tensor input stays on its device, any other array-like goes to
``device`` (``cuda`` by default).
"""
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import (
    _as_inputs,
    _sigmoid_if_logits,
    _softmax_if_logits,
)
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import _one_hot, to_tensor
from metrics_tpu_torch.utils.enums import ClassificationTask

Thresholds = Optional[Union[int, List[float], Tensor, np.ndarray]]


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Union[Tensor, list]] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """fps/tps at every distinct threshold, sklearn-style, on the tensors' device.

    Counts are int64 (float32 with ``sample_weights``, summed in float64).
    """
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    order = torch.sort(preds, stable=True).indices.flip(0)
    preds = preds[order]
    target = target[order]
    target = (target == pos_label).to(torch.int64)
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    last = torch.tensor([target.numel() - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])
    if sample_weights is None:
        tps = torch.cumsum(target, 0)[threshold_idxs]
        fps = 1 + threshold_idxs - tps
    else:
        weight = to_tensor(sample_weights, preds.device).to(torch.float64)[order]
        tps = torch.cumsum(target * weight, 0)[threshold_idxs].to(torch.float32)
        fps = torch.cumsum((1 - target) * weight, 0)[threshold_idxs].to(torch.float32)
    return fps, tps, preds[threshold_idxs]


def _adjust_threshold_arg(thresholds: Thresholds = None, device=None) -> Optional[Tensor]:
    """int/list/tensor thresholds -> 1-D float32 tensor on ``device``.

    An int T gives ``i * float32(1 / (T - 1))`` for i in [0, T - 1), then 1.0: the
    values of ``jnp.linspace(0, 1, T)``, whose division XLA turns into a product with
    the float32 reciprocal.
    """
    if isinstance(thresholds, int):
        step = torch.ones((), dtype=torch.float32, device=device) / (thresholds - 1)
        head = torch.arange(thresholds - 1, dtype=torch.float32, device=device) * step
        return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if thresholds is not None:
        return to_tensor(thresholds, device).to(torch.float32)
    return None


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int, Tensor, np.ndarray)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range, "
            f"but got {thresholds}"
        )
    if isinstance(thresholds, (Tensor, np.ndarray)):
        values = torch.as_tensor(thresholds)
        if values.ndim != 1:
            raise ValueError("If argument `thresholds` is an tensor, expected the tensor to be 1d")
        if not bool(torch.all((values >= 0) & (values <= 1))):
            raise ValueError("If argument `thresholds` is an tensor, expected all elements to be in [0,1] range")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "Expected `preds` and `target` to have the same shape,"
            f" but got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}"
        )
    if target.is_floating_point():
        raise ValueError(
            "Expected argument `target` to be an int or long tensor with ground truth labels"
            f" but got tensor with dtype {target.dtype}"
        )
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be an floating tensor with probability/logit scores,"
            f" but got tensor with dtype {preds.dtype}"
        )
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


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten, sigmoid-if-logits; ignored targets -> -1."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    preds = _sigmoid_if_logits(preds)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Optional[Tensor],
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Binned: the (T, 2, 2) confusion tensor; exact: the inputs themselves."""
    if thresholds is None:
        return preds, target
    preds_t = preds[:, None] >= thresholds[None, :]
    t1 = (target == 1)[:, None]
    t0 = (target == 0)[:, None]
    tp = (preds_t & t1).sum(0)
    fp = (preds_t & t0).sum(0)
    fn = ((~preds_t) & t1).sum(0)
    tn = ((~preds_t) & t0).sum(0)
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def _is_confmat_state(state) -> bool:
    return isinstance(state, Tensor)


def _one_vs_rest(target: Tensor, label: Union[int, Tensor]) -> Tensor:
    """Binary targets of class ``label`` (1) against the rest (0); ignored rows stay -1."""
    return torch.where(target >= 0, (target == label).to(torch.int32), -1)


def _traced_per_column(curve: Callable, preds: Tensor, target: Tensor, multiclass: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """A padded device curve of every column under a trace, in one ``torch.func.vmap``
    over the columns: one batched sort and one scan launch for all of them. A
    multiclass target is binarized one-vs-rest per class, a multilabel one is a
    column per label."""
    if multiclass:
        classes = torch.arange(preds.shape[1], device=preds.device)
        out = torch.func.vmap(lambda p, c: curve(p, _one_vs_rest(target, c)), in_dims=(1, 0))(preds, classes)
    else:
        out = torch.func.vmap(curve, in_dims=(1, 1))(preds, target)
    return out[0], out[1], out[2]


def _binary_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The curve from the confusion tensor (binned) or the raw scores (exact)."""
    if _is_confmat_state(state):
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds

    if not _is_concrete(state[0], state[1]):
        # under a trace: the static-shape device curve; its first K = (~isnan(thresholds)).sum()
        # entries are the eager curve, the precision/recall pads repeat the final (1, 0) point
        from metrics_tpu_torch.ops.clf_curve import binary_precision_recall_curve_padded

        target = state[1] if pos_label == 1 else _one_vs_rest(state[1], pos_label)
        precision, recall, thresholds, _ = binary_precision_recall_curve_padded(state[0], target)
        return precision, recall, thresholds

    preds, target = state
    keep = target >= 0
    fps, tps, thresholds = _binary_clf_curve(preds[keep], target[keep], pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = torch.cat([precision.flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall.flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds.flip(0)


def binary_precision_recall_curve(
    preds,
    target,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall curve for binary tasks: ``(precision, recall, thresholds)``."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_precision_recall_curve_compute(state, thresholds)


# -------------------------------------------------------------------- multiclass


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if not preds.ndim == target.ndim + 1:
        raise ValueError(
            f"Expected `preds` to have one more dimension than `target` but got {preds.ndim} and {target.ndim}"
        )
    if target.is_floating_point():
        raise ValueError(
            f"Expected argument `target` to be an int or long tensor, but got tensor with dtype {target.dtype}"
        )
    if not preds.is_floating_point():
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(
            "Expected `preds.shape[1]` to be equal to the number of classes but"
            f" got {preds.shape[1]} and {num_classes}."
        )
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError(
            "Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...)"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if not _is_concrete(preds, target):
        return
    num_unique_values = torch.unique(target).numel()
    check = num_unique_values > num_classes if ignore_index is None else num_unique_values > num_classes + 1
    if check:
        raise RuntimeError(
            "Detected more unique values in `target` than `num_classes`. Expected only "
            f"{num_classes if ignore_index is None else num_classes + 1} but found "
            f"{num_unique_values} in `target`."
        )


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(N, C, ...) -> (N', C) probabilities and (N',) labels; ignored targets -> -1."""
    preds = torch.movedim(preds, 0, 1).reshape(num_classes, -1).t()
    target = target.reshape(-1)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    preds = _softmax_if_logits(preds)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Binned: the (T, C, 2, 2) confusion tensor; exact: the inputs themselves."""
    if thresholds is None:
        return preds, target
    valid = (target >= 0)[:, None, None]
    preds_t = preds[:, :, None] >= thresholds[None, None, :]
    target_oh = _one_hot(target, num_classes).to(torch.bool)[:, :, None]
    tp = (preds_t & target_oh & valid).sum(0)
    fp = (preds_t & (~target_oh) & valid).sum(0)
    fn = ((~preds_t) & target_oh & valid).sum(0)
    tn = ((~preds_t) & (~target_oh) & valid).sum(0)
    confmat = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)
    return torch.movedim(confmat, 0, 1)


def _multiclass_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_classes: int,
    thresholds: Optional[Tensor],
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if _is_confmat_state(state):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros((1, num_classes), dtype=recall.dtype, device=recall.device)])
        return precision.t(), recall.t(), thresholds

    if not _is_concrete(state[0], state[1]):
        from metrics_tpu_torch.ops.clf_curve import binary_precision_recall_curve_padded

        return _traced_per_column(binary_precision_recall_curve_padded, state[0], state[1], multiclass=True)

    precision, recall, thresholds_out = [], [], []
    for i in range(num_classes):
        res = _binary_precision_recall_curve_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
        precision.append(res[0])
        recall.append(res[1])
        thresholds_out.append(res[2])
    return precision, recall, thresholds_out


def multiclass_precision_recall_curve(
    preds,
    target,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall curve for multiclass tasks, one-vs-rest per class."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)


# -------------------------------------------------------------------- multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """(N, L, ...) -> (N', L); ignored positions -> target -1."""
    preds = torch.movedim(preds, 0, 1).reshape(num_labels, -1).t()
    target = torch.movedim(target, 0, 1).reshape(num_labels, -1).t()
    preds = _sigmoid_if_logits(preds)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Binned: the (T, L, 2, 2) confusion tensor; exact: the inputs themselves."""
    if thresholds is None:
        return preds, target
    valid = (target >= 0)[:, :, None]
    preds_t = preds[:, :, None] >= thresholds[None, None, :]
    t1 = (target == 1)[:, :, None]
    t0 = (target == 0)[:, :, None]
    tp = (preds_t & t1 & valid).sum(0)
    fp = (preds_t & t0 & valid).sum(0)
    fn = ((~preds_t) & t1 & valid).sum(0)
    tn = ((~preds_t) & t0 & valid).sum(0)
    confmat = torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)
    return torch.movedim(confmat, 0, 1)


def _multilabel_precision_recall_curve_compute(
    state: Union[Tensor, Tuple[Tensor, Tensor]],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if _is_confmat_state(state):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones((1, num_labels), dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros((1, num_labels), dtype=recall.dtype, device=recall.device)])
        return precision.t(), recall.t(), thresholds

    if not _is_concrete(state[0], state[1]):
        from metrics_tpu_torch.ops.clf_curve import binary_precision_recall_curve_padded

        return _traced_per_column(binary_precision_recall_curve_padded, state[0], state[1], multiclass=False)

    precision, recall, thresholds_out = [], [], []
    for i in range(num_labels):
        res = _binary_precision_recall_curve_compute((state[0][:, i], state[1][:, i]), thresholds=None, pos_label=1)
        precision.append(res[0])
        recall.append(res[1])
        thresholds_out.append(res[2])
    return precision, recall, thresholds_out


def multilabel_precision_recall_curve(
    preds,
    target,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall curve for multilabel tasks, one per label."""
    preds, target = _as_inputs(preds, target, device)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds,
    target,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    device=None,
):
    """Task dispatcher."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args, device)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision_recall_curve(
            preds, target, num_classes, thresholds, ignore_index, validate_args, device
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision_recall_curve(
            preds, target, num_labels, thresholds, ignore_index, validate_args, device
        )
    raise ValueError(f"Not handled value: {task}")
