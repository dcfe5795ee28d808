"""Panoptic Quality functionals (counterpart of ``metrics_tpu/functional/detection/panoptic_qualities.py``)."""
from typing import Collection

from torch import Tensor

from metrics_tpu_torch.functional.detection._panoptic_quality_common import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _prepare_inputs,
    _preprocess_inputs,
    _validate_inputs,
)


def panoptic_quality(
    preds,
    target,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    device=None,
) -> Tensor:
    r"""Compute Panoptic Quality for panoptic segmentations.

    ``PQ = IoU-sum / (TP + 0.5 FP + 0.5 FN)``, averaged over seen categories. Inputs
    are ``(B, *spatial, 2)`` tensors of ``(category_id, instance_id)`` pixels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.detection import panoptic_quality
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
        >>> round(float(panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.5463
    """
    things, stuffs = _parse_categories(things, stuffs)
    preds, target = _prepare_inputs(preds, target, device)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    flatten_preds = _preprocess_inputs(things, stuffs, preds, void_color, allow_unknown_preds_category)
    flatten_target = _preprocess_inputs(things, stuffs, target, void_color, True)
    iou_sum, true_positives, false_positives, false_negatives = _panoptic_quality_update(
        flatten_preds, flatten_target, cat_id_to_continuous_id, void_color
    )
    return _panoptic_quality_compute(iou_sum, true_positives, false_positives, false_negatives)


def modified_panoptic_quality(
    preds,
    target,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    device=None,
) -> Tensor:
    r"""Compute Modified Panoptic Quality: stuff classes use ``IoU-sum / num_segments``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.detection import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> round(float(modified_panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
        0.7667
    """
    things, stuffs = _parse_categories(things, stuffs)
    preds, target = _prepare_inputs(preds, target, device)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    flatten_preds = _preprocess_inputs(things, stuffs, preds, void_color, allow_unknown_preds_category)
    flatten_target = _preprocess_inputs(things, stuffs, target, void_color, True)
    iou_sum, true_positives, false_positives, false_negatives = _panoptic_quality_update(
        flatten_preds,
        flatten_target,
        cat_id_to_continuous_id,
        void_color,
        modified_metric_stuffs=stuffs,
    )
    return _panoptic_quality_compute(iou_sum, true_positives, false_positives, false_negatives)
