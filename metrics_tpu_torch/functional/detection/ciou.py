"""CIoU functional (counterpart of ``metrics_tpu/functional/detection/ciou.py``)."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.detection.box_ops import complete_box_iou


def _ciou_update(preds, target, iou_threshold: Optional[float], replacement_val: float = 0, device=None) -> Tensor:
    iou = complete_box_iou(preds, target, device=device)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.full_like(iou, replacement_val), iou)
    return iou


def _ciou_compute(iou: Tensor, labels_eq: bool = True) -> Tensor:
    if labels_eq:
        return torch.diagonal(iou).mean()
    return iou.mean()


def complete_intersection_over_union(
    preds,
    target,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
    device=None,
) -> Tensor:
    """Compute Complete Intersection over Union between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.detection import complete_intersection_over_union
        >>> preds = torch.tensor([[100.0, 100.0, 200.0, 200.0]])
        >>> target = torch.tensor([[110.0, 110.0, 210.0, 210.0]])
        >>> round(float(complete_intersection_over_union(preds, target)), 4)
        0.6724
    """
    iou = _ciou_update(preds, target, iou_threshold, replacement_val, device)
    return _ciou_compute(iou) if aggregate else iou
