from metrics_tpu_torch.functional.detection.box_ops import (
    box_area,
    box_convert,
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from metrics_tpu_torch.functional.detection.ciou import complete_intersection_over_union
from metrics_tpu_torch.functional.detection.diou import distance_intersection_over_union
from metrics_tpu_torch.functional.detection.giou import generalized_intersection_over_union
from metrics_tpu_torch.functional.detection.iou import intersection_over_union
from metrics_tpu_torch.functional.detection.panoptic_qualities import modified_panoptic_quality, panoptic_quality

__all__ = [
    "box_area",
    "box_convert",
    "box_iou",
    "complete_box_iou",
    "complete_intersection_over_union",
    "distance_box_iou",
    "distance_intersection_over_union",
    "generalized_box_iou",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
