"""DistanceIntersectionOverUnion metric (counterpart of ``metrics_tpu/detection/diou.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.detection.iou import IntersectionOverUnion
from metrics_tpu_torch.functional.detection.diou import _diou_compute, _diou_update


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    r"""Computes Distance Intersection Over Union (DIoU).

    Same input/output contract as :class:`~metrics_tpu_torch.detection.IntersectionOverUnion`;
    result keys are prefixed ``diou``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import DistanceIntersectionOverUnion
        >>> preds = [
        ...    {
        ...        "boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]]),
        ...        "scores": torch.tensor([0.236, 0.56]),
        ...        "labels": torch.tensor([4, 5]),
        ...    }
        ... ]
        >>> target = [
        ...    {
        ...        "boxes": torch.tensor([[300.00, 100.00, 315.00, 150.00]]),
        ...        "labels": torch.tensor([5]),
        ...    }
        ... ]
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> {k: round(float(v), 4) for k, v in metric(preds, target).items()}
        {'diou': -0.0694}
    """

    _iou_type: str = "diou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(box_format, iou_threshold, class_metrics, respect_labels, **kwargs)

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _diou_update(*args, **kwargs)

    @staticmethod
    def _iou_compute_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _diou_compute(*args, **kwargs)
