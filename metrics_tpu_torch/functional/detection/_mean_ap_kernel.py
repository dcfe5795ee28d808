"""Greedy COCO matching for MeanAveragePrecision (counterpart of
``metrics_tpu/functional/detection/_mean_ap_kernel.py``).

The JAX package matches every (image, class) group at once: one ``lax.scan`` over the
score-sorted detections, all IoU thresholds as one ``(T, G)`` mask update, vmapped
over the COCO area ranges and the groups. Here the box IoU and areas are torch ops
(:mod:`~metrics_tpu_torch.functional.detection.box_ops`, bit-equal to the JAX ones)
and the scan is :func:`metrics_tpu_torch.ops.greedy_match.greedy_match`: the
hand-written kernel on the card, its plain version on the CPU. Shapes are padded by
the callers to power-of-two buckets, as in the JAX package.

``_match_groups`` computes box IoU and areas itself; ``_match_groups_from_iou`` (and
``_per_group_from_iou``, the same launch) takes them precomputed (the segm path's
mask IoU). Both return ``det_matched (N, A, T, D)``, ``det_ignored (N, A, T, D)`` and
``npig (N, A)``.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.detection.box_ops import box_area, box_iou
from metrics_tpu_torch.ops.greedy_match import greedy_match
from metrics_tpu_torch.utils.data import _next_pow2

_IOU_CHUNK = 1 << 26  # box pairs per IoU chunk: bounds the (groups, D, G, 2) intermediates of eager ops


def _match_groups_core(
    det_boxes: Tensor,   # (N, D, 4) score-sorted per group, zero-padded
    det_valid: Tensor,   # (N, D) bool
    gt_boxes: Tensor,    # (N, G, 4) zero-padded
    gt_valid: Tensor,    # (N, G) bool
    iou_thresholds: Tensor,  # (T,) float32
    area_ranges: Tensor,     # (A, 2) [lo, hi] float32
):
    """Box matching for all groups x area ranges x IoU thresholds: one match launch.

    The box IoU goes in chunks of groups (elementwise, so the bits do not change): XLA
    fuses it, eager ops materialise each intermediate at the full padded shape.
    """
    n = det_boxes.shape[0]
    step = max(1, _IOU_CHUNK // max(1, det_boxes.shape[1] * gt_boxes.shape[1]))
    if n > step:
        iou = torch.cat([box_iou(det_boxes[s:s + step], gt_boxes[s:s + step]) for s in range(0, n, step)])
    else:
        iou = box_iou(det_boxes, gt_boxes)
    return greedy_match(iou, box_area(det_boxes), box_area(gt_boxes), det_valid, gt_valid, iou_thresholds, area_ranges)


_match_groups = _match_groups_core
# the JAX package's per-group scan and its vmapped form are one batched launch here
_per_group_from_iou = _match_groups_from_iou = greedy_match

_pow2 = _next_pow2  # shared bucketing helper (utils/data.py)
