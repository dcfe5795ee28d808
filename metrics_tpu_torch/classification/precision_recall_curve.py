"""Precision-recall curve metric classes (counterpart of
``metrics_tpu/classification/precision_recall_curve.py``).

State: ``preds``/``target`` cat lists of the formatted scores and targets
(``thresholds=None``, exact mode), one summed ``(T, ..., 2, 2)`` int64 ``confmat``
(binned mode), or, for the scalar AUROC/AP subclasses with ``tolerance > 0`` (the
sketch tier, JAX :61-175), int32 ``pos_hist``/``neg_hist`` bucket histograms of the
top ``tolerance_bits`` score-key bits, ``(2^bits,)`` or ``(C, 2^bits)`` one-vs-rest
or per label: fixed-size state, no cat buffer and no sort; ``compute`` serves the
certified bracket's midpoint (``ops/rank.py``). An update counts a binary metric in
two mask-mode launches of the histogram kernel, and all C lanes of a multiclass or
multilabel one in two launches of its batched mode over the ``(C, N)`` bucket ids
(the JAX package launches twice a lane); the counts are the same.
"""
from typing import Any, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.ops import rank as _rank
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.data import _count_dtype, dim_zero_cat
from metrics_tpu_torch.utils.enums import ClassificationTask
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _exact_cat_state(preds_state: Any, target_state: Any) -> Tuple[Tensor, Tensor]:
    """The exact-mode (preds, target) of cat states, concatenated.

    Under a trace (``torch.func.vmap`` over bootstrap copies, a capture) ``CatBuffer``
    states give their whole ``data``, the targets of the rows past the count set to
    -1, which the device curves mask: the shapes stay the buffer's, as under the JAX
    package's ``jit``. Eagerly the valid rows alone, as in the JAX package.
    """
    if isinstance(preds_state, CatBuffer) and not _is_concrete(preds_state.data, target_state.data):
        mask = target_state.mask()
        mask = mask.reshape(mask.shape + (1,) * (target_state.data.dim() - 1))
        return preds_state.data, torch.where(mask, target_state.data, -1)
    return dim_zero_cat(preds_state), dim_zero_cat(target_state)


class _PrecisionRecallCurveBase(Metric):
    """Shared state handling of the curve family: exact cat lists, a binned confmat or
    the sketch tier's bucket histograms."""

    # the scalar AUROC/AP subclasses take the sketch tier; curve-shaped outputs need
    # the exact state
    _sketch_computable: bool = False

    def _init_curve_state(
        self,
        thresholds: Thresholds,
        tolerance: float,
        tolerance_bits: int,
        confmat_shape: Tuple[int, ...],
        target_item_shape: Tuple[int, ...] = (),
    ) -> None:
        """Validate the tolerance knobs as the JAX package does, then register the states.

        ``confmat_shape`` is the per-threshold shape of the binned confusion tensor; its
        leading axes are the shape of one exact ``preds`` row (and the lanes of the
        sketch histograms), and ``target_item_shape`` that of one ``target`` row (for
        ``cat_capacity`` buffers). The checks are structural and run even with
        ``validate_args=False``.
        """
        self.tolerance = float(tolerance)
        self.tolerance_bits = int(tolerance_bits)
        if self.tolerance < 0:
            raise ValueError(f"Expected argument `tolerance` to be non-negative, but got {tolerance}")
        if not 4 <= self.tolerance_bits <= 14:
            raise ValueError(f"Expected argument `tolerance_bits` to be an int in [4, 14], but got {tolerance_bits}")
        if self.tolerance > 0:
            if not self._sketch_computable:
                raise ValueError(
                    "`tolerance > 0` requires a scalar sketch-computable metric (AUROC / AveragePrecision); "
                    f"{self.__class__.__name__} emits curve-shaped outputs that need the exact state."
                )
            if thresholds is not None:
                raise ValueError(
                    "`tolerance > 0` applies to exact mode only — binned mode (`thresholds` set) "
                    "is already constant-memory."
                )
        thresholds = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thresholds, persistent=False)
        if self.tolerance > 0:
            shape = (*confmat_shape[:-2], 1 << self.tolerance_bits)
            self.add_state("pos_hist", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("neg_hist", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")
        elif thresholds is None:
            self.add_state(
                "preds", [], dist_reduce_fx="cat", cat_item_shape=confmat_shape[:-2], cat_dtype=torch.float32
            )
            self.add_state(
                "target", [], dist_reduce_fx="cat", cat_item_shape=target_item_shape, cat_dtype=torch.int32
            )
        else:
            self.add_state(
                "confmat", torch.zeros((len(thresholds), *confmat_shape), dtype=_count_dtype()), dist_reduce_fx="sum"
            )

    def _accumulate(self, state: Union[Tensor, Tuple[Tensor, Tensor]]) -> None:
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _sketch_update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the class bucket histograms of formatted inputs (ignored targets
        -1). 2-D ``preds`` are one-vs-rest lanes: beside a 1-D label vector
        (multiclass) or per-label targets whose validity is per lane (multilabel)."""
        bits = self.tolerance_bits
        if preds.dim() == 1:
            pos, neg = _rank.hist_class_counts(preds, target == 1, target >= 0, bits)
        else:
            if target.dim() == 1:  # multiclass one-vs-rest
                lanes = torch.arange(preds.shape[1], device=preds.device)
                valid = (target >= 0).unsqueeze(1).expand(preds.shape)
                pos_mask = target.unsqueeze(1) == lanes
            else:  # multilabel
                valid, pos_mask = target >= 0, target == 1
            keys = _rank.monotone_key_descending(preds, valid)
            pos, neg = _rank.class_bucket_counts_lanes(keys.t(), pos_mask.t(), valid.t(), bits)
        self.pos_hist = self.pos_hist + pos
        self.neg_hist = self.neg_hist + neg

    def _sketch_scores(self, kind: str, op: str, micro: bool = False) -> Tuple[Tensor, Tensor]:
        """(bracket midpoint, positive totals) from the histogram states, as float32.

        ``micro`` sums the lanes first (they share one key space: the micro flatten).
        Warns when the realized bracket is wider than ``tolerance`` (scores packed into
        few binades defeat the exponent-keyed buckets); the midpoint is still inside it.
        """
        pos, neg = self.pos_hist, self.neg_hist
        if micro:
            pos, neg = pos.sum(0), neg.sum(0)
        lo, hi = (_rank.hist_auroc_bounds if kind == "auroc" else _rank.hist_ap_bounds)(pos, neg)
        pos_tot = torch.sum(pos, -1)
        _rank.record_dispatch("sketch", op)
        width = torch.max(hi - lo)
        if _is_concrete(width) and float(width) > self.tolerance:
            rank_zero_warn(
                f"Certified bound width {float(width):.3g} exceeds tolerance={self.tolerance} at "
                f"tolerance_bits={self.tolerance_bits}. The served midpoint still lies inside the "
                "certificate; raise `tolerance_bits` or use `tolerance=0` (exact tier) if needed.",
                UserWarning,
            )
        mid = 0.5 * (lo + hi)
        if kind == "ap":
            mid = torch.where(pos_tot > 0, mid, float("nan"))  # the exact tier's no-positives NaN
        return mid.to(torch.float32), pos_tot.to(torch.float32)

    def _curve_state(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """The binned confusion tensor, or the exact (preds, target) of
        :func:`_exact_cat_state`."""
        if self.thresholds is None:
            return _exact_cat_state(self.preds, self.target)
        return self.confmat

    def plot(self, curve=None, score=None, ax=None):
        """Plot the precision-recall curve (``compute()`` by default). Returns
        ``(figure, axis)``.

        A subclass whose value is not a curve (AUROC, AP: a tensor; a fixed point: its
        ``(value, threshold)``) plots the value as :meth:`Metric.plot` does (the JAX
        package hands it to the curve plot, which raises).
        """
        from metrics_tpu_torch.utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        if isinstance(curve, Tensor) or len(curve) == 2:
            return Metric.plot(self, curve if isinstance(curve, Tensor) else curve[0], ax)
        return plot_curve(
            (curve[1], curve[0], curve[2]), score=score, ax=ax,
            label_names=("Recall", "Precision"), name=self.__class__.__name__,
        )


class BinaryPrecisionRecallCurve(_PrecisionRecallCurveBase):
    """Binary precision-recall curve: ``(precision, recall, thresholds)``."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("thresholds", "ignore_index", "tolerance", "tolerance_bits")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        tolerance: float = 0.0,
        tolerance_bits: int = 12,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, tolerance, tolerance_bits, (2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        if self.tolerance > 0:
            self._sketch_update(preds, target)
            return
        self._accumulate(_binary_precision_recall_curve_update(preds, target, self.thresholds))

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)


class MulticlassPrecisionRecallCurve(_PrecisionRecallCurveBase):
    """Multiclass precision-recall curves, one-vs-rest per class."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_classes", "thresholds", "ignore_index", "tolerance", "tolerance_bits")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        tolerance: float = 0.0,
        tolerance_bits: int = 12,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, tolerance, tolerance_bits, (num_classes, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, None, self.ignore_index
        )
        if self.tolerance > 0:
            self._sketch_update(preds, target)
            return
        self._accumulate(_multiclass_precision_recall_curve_update(preds, target, self.num_classes, self.thresholds))

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelPrecisionRecallCurve(_PrecisionRecallCurveBase):
    """Multilabel precision-recall curves, one per label."""

    # update-relevant constructor arguments (compute groups)
    _update_signature_attrs = ("num_labels", "thresholds", "ignore_index", "tolerance", "tolerance_bits")

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        tolerance: float = 0.0,
        tolerance_bits: int = 12,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, tolerance, tolerance_bits, (num_labels, 2, 2), (num_labels,))

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        if self.tolerance > 0:
            self._sketch_update(preds, target)
            return
        self._accumulate(_multilabel_precision_recall_curve_update(preds, target, self.num_labels, self.thresholds))

    def compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index
        )


class PrecisionRecallCurve:
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
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
        raise ValueError(f"Not handled value: {task}")
