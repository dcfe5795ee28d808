from metrics_tpu_torch.detection.ciou import CompleteIntersectionOverUnion
from metrics_tpu_torch.detection.diou import DistanceIntersectionOverUnion
from metrics_tpu_torch.detection.giou import GeneralizedIntersectionOverUnion
from metrics_tpu_torch.detection.iou import IntersectionOverUnion
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from metrics_tpu_torch.detection.panoptic_qualities import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
