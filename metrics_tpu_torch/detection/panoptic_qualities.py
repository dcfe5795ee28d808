"""PanopticQuality / ModifiedPanopticQuality (counterpart of ``metrics_tpu/detection/panoptic_qualities.py``).

The states are per-category sums: ``iou_sum`` in float64, the TP/FP/FN counts in
int32, each reduced by ``"sum"`` across processes.
"""
from typing import Any, Collection

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.detection._panoptic_quality_common import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)


class PanopticQuality(Metric):
    r"""Compute Panoptic Quality for panoptic segmentations.

    ``PQ = IoU-sum / (TP + 0.5 FP + 0.5 FN)`` averaged over seen categories. Inputs are
    ``(B, *spatial, 2)`` tensors of ``(category_id, instance_id)`` pixels; instance ids
    of stuff categories are ignored.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import PanopticQuality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [7, 0], [6, 0], [1, 0]],
        ...                        [[0, 0], [7, 0], [7, 0], [7, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [1, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [7, 0], [7, 0]]]])
        >>> panoptic_quality = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> round(float(panoptic_quality(preds, target)), 4)
        0.5463
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _modified: bool = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        things, stuffs = _parse_categories(things, stuffs)
        self.things = things
        self.stuffs = stuffs
        self.void_color = _get_void_color(things, stuffs)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category

        n_categories = len(things) + len(stuffs)
        self.add_state("iou_sum", default=torch.zeros(n_categories, dtype=torch.float64), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate panoptic stat scores from a batch of panoptic pixel maps."""
        _validate_inputs(preds, target)
        flatten_preds = _preprocess_inputs(
            self.things, self.stuffs, preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _preprocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, true_positives, false_positives, false_negatives = _panoptic_quality_update(
            flatten_preds,
            flatten_target,
            self.cat_id_to_continuous_id,
            self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified else None,
        )
        self.iou_sum = self.iou_sum + iou_sum
        self.true_positives = self.true_positives + true_positives
        self.false_positives = self.false_positives + false_positives
        self.false_negatives = self.false_negatives + false_negatives

    def compute(self) -> Tensor:
        """Final Panoptic Quality from the accumulated stat scores."""
        return _panoptic_quality_compute(self.iou_sum, self.true_positives, self.false_positives, self.false_negatives)


class ModifiedPanopticQuality(PanopticQuality):
    r"""Compute Modified Panoptic Quality: stuff classes use ``IoU-sum / num_segments``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> pq_modified = ModifiedPanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> round(float(pq_modified(preds, target)), 4)
        0.7667
    """

    _modified: bool = True
