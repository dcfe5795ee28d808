"""The legacy classification input pipeline that ``Dice`` runs on (counterpart of
``metrics_tpu/functional/classification/_legacy.py``): input-case detection and its
checks, the one-hot format, ``_stat_scores_update`` and ``_reduce_stat_scores``.

The case is decided from shapes and values, so the checks read values back to the
host, as in the JAX package; the counts are torch ops on the inputs' device, int64.
A float ``(N, C, ...)`` input takes its top-1 one-hot from ``argmax`` (the first
largest score, as the JAX package's stable top-k picks it).
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _input_squeeze(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop excess size-1 dimensions, keeping the batch axis of a batch of one."""
    if preds.shape[0] == 1:
        return preds.squeeze()[None, ...], target.squeeze()[None, ...]
    return preds.squeeze(), target.squeeze()


def _basic_input_validation(
    preds: Tensor, target: Tensor, threshold: float, multiclass: Optional[bool], ignore_index: Optional[int]
) -> None:
    if preds.numel() == 0 and target.numel() == 0:
        return
    if target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")
    t_min = int(target.min())
    if (ignore_index is None and t_min < 0) or (ignore_index and ignore_index >= 0 and t_min < 0):
        raise ValueError("The `target` has to be a non-negative tensor.")
    preds_float = preds.is_floating_point()
    if not preds_float and int(preds.min()) < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if not preds.shape[0] == target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    if multiclass is False and int(target.max()) > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and int(preds.max()) > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> Tuple[DataType, int]:
    preds_float = preds.is_floating_point()
    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        if preds_float and target.numel() > 0 and int(target.max()) > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1:
            case = DataType.BINARY if preds_float else DataType.MULTICLASS
        else:
            case = DataType.MULTILABEL if preds_float else DataType.MULTIDIM_MULTICLASS
        implied_classes = int(torch.tensor(preds.shape[1:]).prod()) if preds.numel() > 0 else 0
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    return case, implied_classes


def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> DataType:
    """The legacy checks, with the JAX package's errors; returns the input case."""
    _basic_input_validation(preds, target, threshold, multiclass, ignore_index)
    case, implied_classes = _check_shape_and_type_consistency(preds, target)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if target.numel() > 0 and int(target.max()) >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )

    if num_classes:
        if case == DataType.BINARY:
            if num_classes > 2:
                raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
            if num_classes == 2 and not multiclass:
                raise ValueError(
                    "Your data is binary and `num_classes=2`, but `multiclass` is not True."
                    " Set it to True if you want to transform binary data to multi-class format."
                )
            if num_classes == 1 and multiclass:
                raise ValueError(
                    "You have binary data and have set `multiclass=True`, but `num_classes` is 1."
                    " Either set `multiclass=None`(default) or set `num_classes=2`"
                    " to transform binary data to multi-class format."
                )
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            if num_classes == 1 and multiclass is not False:
                raise ValueError(
                    "You have set `num_classes=1`, but predictions are integers."
                    " If you want to convert (multi-dimensional) multi-class data with 2 classes"
                    " to binary/multi-label, set `multiclass=False`."
                )
            if num_classes > 1:
                if multiclass is False and implied_classes != num_classes:
                    raise ValueError(
                        "You have set `multiclass=False`, but the implied number of classes "
                        " (from shape of inputs) does not match `num_classes`."
                    )
                if target.numel() > 0 and num_classes <= int(target.max()):
                    raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
                if preds.shape != target.shape and num_classes != implied_classes:
                    raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")
        elif case == DataType.MULTILABEL:
            if multiclass and num_classes != 2:
                raise ValueError(
                    "Your have set `multiclass=True`, but `num_classes` is not equal to 2."
                    " If you are trying to transform multi-label data to 2 class multi-dimensional"
                    " multi-class, you should set `num_classes` to either 2 or None."
                )
            if not multiclass and num_classes != implied_classes:
                raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")

    if top_k is not None:
        if case == DataType.BINARY:
            raise ValueError("You can not use `top_k` parameter with binary data.")
        if not isinstance(top_k, int) or top_k <= 0:
            raise ValueError("The `top_k` has to be an integer larger than 0.")
        if not preds.is_floating_point():
            raise ValueError("You have set `top_k`, but you do not have probability predictions.")
        if multiclass is False:
            raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
        if case == DataType.MULTILABEL and multiclass:
            raise ValueError(
                "If you want to transform multi-label data to 2 class multi-dimensional"
                "multi-class data using `multiclass=True`, you can not use `top_k`."
            )
        if top_k >= implied_classes:
            raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")

    return case


def _top_one_hot(preds: Tensor, top_k: int) -> Tensor:
    """int32 mask of the ``top_k`` largest scores along dim 1; top-1 by ``argmax``."""
    if top_k == 1:
        return to_onehot(preds.argmax(dim=1), preds.shape[1])
    return select_topk(preds, top_k)


def _input_format_classification(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Inputs of any legacy case -> int32 one-hot ``(N, C[, X])`` preds and target."""
    preds, target = _input_squeeze(preds, target)
    if preds.dtype == torch.float16:
        preds = preds.to(torch.float32)

    case = _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k,
        ignore_index=ignore_index,
    )

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32) if preds.is_floating_point() else preds
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = _top_one_hot(preds, top_k or 1)
        else:
            num_classes = num_classes or int(max(int(preds.max()), int(target.max())) + 1)
            preds = to_onehot(preds, max(2, num_classes))
        target = to_onehot(target, max(2, num_classes))
        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if preds.numel() > 0 or target.numel() > 0:
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds = preds.squeeze(-1)
    if target.ndim > 2 and target.shape[-1] == 1:
        target = target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _del_column(data: Tensor, idx: int) -> Tensor:
    return torch.cat([data[:, :idx], data[:, (idx + 1):]], dim=1)


def _drop_negative_ignored_indices(
    preds: Tensor, target: Tensor, ignore_index: int, mode: DataType
) -> Tuple[Tensor, Tensor]:
    """Remove the samples whose (negative) target is ``ignore_index``."""
    if mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point():
        preds = torch.movedim(preds, 1, -1)
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    elif mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return preds, target


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int64 tp/fp/tn/fn of one-hot ``preds``/``target``, summed as ``reduce`` says."""
    dim: Union[int, Tuple[int, ...]] = 1  # "samples"
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0
    tp = (true_pred & pos_pred).sum(dim=dim)
    fp = (false_pred & pos_pred).sum(dim=dim)
    tn = (true_pred & neg_pred).sum(dim=dim)
    fn = (false_pred & neg_pred).sum(dim=dim)
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = 1,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Legacy stat scores of one batch: an ignored class is deleted (micro, samples)
    or marked -1 (macro)."""
    negative_index_dropped = False
    if ignore_index is not None and ignore_index < 0 and mode is not None:
        preds, target = _drop_negative_ignored_indices(preds, target, ignore_index, mode)
        negative_index_dropped = True

    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k,
        ignore_index=ignore_index,
    )

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro" and not negative_index_dropped:
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro" and not negative_index_dropped:
        tp[..., ignore_index] = -1
        fp[..., ignore_index] = -1
        tn[..., ignore_index] = -1
        fn[..., ignore_index] = -1

    return tp, fp, tn, fn


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Score reduction with zero-division and ignore masks, in float32."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / weights.sum(dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, float("nan"), scores)
    return scores.sum()
