"""IntersectionOverUnion metric (counterpart of ``metrics_tpu/detection/iou.py``).

Per image, the IoU matrix of the detections against the ground truths is computed on
the metric's device, pairs of differing labels set to the invalid value when the two
label lists differ (``respect_labels``). Whether they differ is decided on the device
and read once at ``compute``, so an update waits on nothing.
"""
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.detection.helpers import DetectionInputs, _fix_empty_tensors, _input_validator, _to_host
from metrics_tpu_torch.functional.detection.box_ops import box_convert
from metrics_tpu_torch.functional.detection.iou import _iou_compute, _iou_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class IntersectionOverUnion(DetectionInputs, Metric):
    r"""Computes Intersection Over Union (IoU) between detection and ground-truth boxes.

    ``preds``/``target`` are lists of per-image dicts: preds carry ``boxes`` (N, 4),
    ``scores`` (N,), ``labels`` (N,); targets carry ``boxes`` and ``labels``.
    ``compute`` returns ``{"iou": scalar}`` plus per-class entries when
    ``class_metrics=True``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import IntersectionOverUnion
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
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> {k: round(float(v), 4) for k, v in metric(preds, target).items()}
        {'iou': 0.4307}
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    _iou_type: str = "iou"
    _invalid_val: float = 0.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")

        self.box_format = box_format
        self.iou_threshold = iou_threshold

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("results", default=[], dist_reduce_fx=None)
        self.add_state("labels_eq", default=[], dist_reduce_fx=None)

    @staticmethod
    def _iou_update_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _iou_update(*args, **kwargs)

    @staticmethod
    def _iou_compute_fn(*args: Any, **kwargs: Any) -> Tensor:
        return _iou_compute(*args, **kwargs)

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        """Accumulate per-image IoU matrices."""
        _input_validator(preds, target)

        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            self.groundtruth_labels.append(t["labels"])

            same_shape = p["labels"].shape == t["labels"].shape
            label_eq = torch.all(p["labels"] == t["labels"]) if same_shape else torch.zeros((), dtype=torch.bool)
            label_eq = label_eq.to(self.device)
            self.labels_eq.append(label_eq.reshape(1).to(torch.int32))

            ious = self._iou_update_fn(det_boxes, gt_boxes, self.iou_threshold, self._invalid_val)
            if self.respect_labels:
                replace = (p["labels"][:, None] != t["labels"][None, :]) & ~label_eq
                ious = torch.where(replace, torch.full_like(ious, self._invalid_val), ious)
            self.results.append(ious.to(torch.float32))

    def _get_safe_item_values(self, boxes: Tensor) -> Tensor:
        boxes = _fix_empty_tensors(boxes)
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _gt_labels_host(self) -> List[np.ndarray]:
        return _to_host(list(self.groundtruth_labels))

    def _get_gt_classes(self) -> List:
        """Unique classes found in ground truth data."""
        if len(self.groundtruth_labels) > 0:
            return sorted(np.unique(np.concatenate(self._gt_labels_host())).tolist())
        return []

    def compute(self) -> dict:
        """Aggregate accumulated IoU matrices into scalar score(s)."""
        labels_eq = torch.cat(list(self.labels_eq)).tolist() if len(self.labels_eq) else []
        aggregated_iou = dim_zero_cat(
            [torch.atleast_1d(self._iou_compute_fn(iou, bool(eq))) for iou, eq in zip(self.results, labels_eq)]
        ) if len(self.results) else torch.zeros(0, device=self.device)
        results: Dict[str, Tensor] = {f"{self._iou_type}": aggregated_iou.mean()}

        if self.class_metrics:
            labels = self._gt_labels_host()
            gt_classes = sorted(np.unique(np.concatenate(labels)).tolist()) if labels else []
            class_results: Dict[int, List[Tensor]] = defaultdict(list)
            for iou, label in zip(self.results, labels):
                for cl in gt_classes:
                    keep = label == cl
                    if iou.shape[0] * int(keep.sum()) > 0:
                        masked_iou = iou[:, torch.from_numpy(keep).to(iou.device)]
                        class_results[cl].append(torch.atleast_1d(self._iou_compute_fn(masked_iou, False)))
            results.update(
                {f"{self._iou_type}/cl_{cl}": dim_zero_cat(class_results[cl]).mean() for cl in class_results}
            )
        return results
