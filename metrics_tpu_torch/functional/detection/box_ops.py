"""Pairwise box geometry (counterpart of ``metrics_tpu/functional/detection/box_ops.py``).

Each function is a broadcast over ``(..., N, 1, 4) x (..., 1, M, 4)`` in float32, in
the JAX package's order of operations (:39-111), so that the IoU bits equal its own:
greedy matching compares IoU to float32 thresholds with a strict ``>``, and boxes
on integer coordinates give IoUs of exactly 0.5 and 0.75. Leading batch dimensions
are allowed (the mAP matcher passes ``(groups, D, 4)`` and ``(groups, G, 4)``); for
2-D inputs every function is the JAX one. Squares are written as products, as
``jax.lax.integer_pow`` computes them.

All boxes are ``(x1, y1, x2, y2)`` with ``0 <= x1 < x2`` and ``0 <= y1 < y2``.
"""
import math

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor

_EPS = 1e-7  # the stabiliser torchvision uses for the d/c-iou denominators


def _f32(x, device=None) -> Tensor:
    return to_tensor(x, device).to(torch.float32)


def box_convert(boxes, in_fmt: str, out_fmt: str = "xyxy", device=None) -> Tensor:
    """Convert ``(..., 4)`` boxes from ``xyxy``/``xywh``/``cxcywh`` to ``xyxy``."""
    if in_fmt == out_fmt:
        return boxes
    if out_fmt != "xyxy":
        raise ValueError(f"Only conversion to 'xyxy' is supported, got {out_fmt}")
    boxes = _f32(boxes, device)
    a, b, c, d = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    if in_fmt == "xywh":
        return torch.stack([a, b, a + c, b + d], dim=-1)
    if in_fmt == "cxcywh":
        return torch.stack([a - c / 2, b - d / 2, a + c / 2, b + d / 2], dim=-1)
    raise ValueError(f"Unsupported box format {in_fmt!r}; expected one of ('xyxy', 'xywh', 'cxcywh')")


def box_area(boxes, device=None) -> Tensor:
    """Areas of ``(..., 4)`` xyxy boxes."""
    boxes = _f32(boxes, device)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(preds: Tensor, target: Tensor):
    """Pairwise intersection and union: ``(..., N, 4), (..., M, 4) -> (..., N, M)`` twice."""
    lt = torch.maximum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.minimum(preds[..., :, None, 2:], target[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(preds)[..., :, None] + box_area(target)[..., None, :] - inter
    return inter, union


def box_iou(preds, target, device=None) -> Tensor:
    """Pairwise IoU matrix ``(..., N, M)``; 0 where the union is empty."""
    preds, target = _f32(preds, device), _f32(target, device)
    inter, union = _inter_union(preds, target)
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, torch.ones_like(union)), torch.zeros_like(union))


def _enclosing_wh(preds: Tensor, target: Tensor) -> Tensor:
    """Width/height of the smallest box enclosing each pair: ``(..., N, M, 2)``."""
    lt = torch.minimum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.maximum(preds[..., :, None, 2:], target[..., None, :, 2:])
    return torch.clamp(rb - lt, min=0)


def generalized_box_iou(preds, target, device=None) -> Tensor:
    """Pairwise GIoU matrix: ``iou - (enclosing_area - union) / enclosing_area``."""
    preds, target = _f32(preds, device), _f32(target, device)
    inter, union = _inter_union(preds, target)
    iou = inter / union
    whi = _enclosing_wh(preds, target)
    enclosing = whi[..., 0] * whi[..., 1]
    return iou - (enclosing - union) / enclosing


def _diou_iou(preds: Tensor, target: Tensor):
    iou = box_iou(preds, target)
    whi = _enclosing_wh(preds, target)
    diag_sq = whi[..., 0] * whi[..., 0] + whi[..., 1] * whi[..., 1] + _EPS
    cx_p = (preds[..., 0] + preds[..., 2]) / 2
    cy_p = (preds[..., 1] + preds[..., 3]) / 2
    cx_t = (target[..., 0] + target[..., 2]) / 2
    cy_t = (target[..., 1] + target[..., 3]) / 2
    dx = cx_p[..., :, None] - cx_t[..., None, :]
    dy = cy_p[..., :, None] - cy_t[..., None, :]
    center_sq = dx * dx + dy * dy
    return iou - center_sq / diag_sq, iou


def distance_box_iou(preds, target, device=None) -> Tensor:
    """Pairwise DIoU matrix: ``iou - center_distance² / enclosing_diagonal²``."""
    preds, target = _f32(preds, device), _f32(target, device)
    diou, _ = _diou_iou(preds, target)
    return diou


def complete_box_iou(preds, target, device=None) -> Tensor:
    """Pairwise CIoU matrix: ``diou - alpha * v`` with the aspect-ratio term ``v``."""
    preds, target = _f32(preds, device), _f32(target, device)
    diou, iou = _diou_iou(preds, target)
    w_p = preds[..., 2] - preds[..., 0]
    h_p = preds[..., 3] - preds[..., 1]
    w_t = target[..., 2] - target[..., 0]
    h_t = target[..., 3] - target[..., 1]
    angle = torch.atan(w_t / h_t)[..., None, :] - torch.atan(w_p / h_p)[..., :, None]
    v = (4 / math.pi**2) * (angle * angle)
    alpha = v / (1 - iou + v + _EPS)
    return diou - alpha * v
