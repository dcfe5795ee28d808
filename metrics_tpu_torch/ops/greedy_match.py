"""Greedy COCO matching of score-sorted detections: the sequential step of mAP.

Counterpart of ``metrics_tpu/functional/detection/_mean_ap_kernel.py:_per_group_from_iou``
(:26), which the JAX package runs as one ``lax.scan`` over the detections, vmapped
over area ranges and groups, compiled by XLA into one loop on the device. Here:

- **CPU tensors:** :func:`_plain_greedy_match`, the scan written out as a loop over
  the D detections of batched tensor ops over ``(N, A, T, G)``. It is also the
  kernel's reference in the tests and in ``chip_smoke.py``.
- **CUDA tensors:** the hand-written kernel in ``csrc/greedy_match.cu`` through
  :data:`greedy_match_cuda`, one launch a call: a thread per group, area range and
  threshold for narrow groups, a warp per triple for wide groups or few triples (the
  C function picks). There is no fallback: a CUDA input the kernel does not take
  raises.

Inputs: IoU ``(N, D, G)`` float32 with score-sorted detection rows, ``d_area (N, D)``
and ``g_area (N, G)`` float32, ``det_valid (N, D)`` and ``gt_valid (N, G)`` bool,
thresholds ``(T,)`` float32 and area ranges ``(A, 2)`` float32. Outputs:
``det_matched (N, A, T, D)`` and ``det_ignored (N, A, T, D)`` bool, ``npig (N, A)``
int32. Both paths give the JAX scan's masks bit for bit.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build

KERNEL_MAX_G = 4096  # csrc/greedy_match.cu:kMaxG


def _plain_greedy_match(
    iou: Tensor, d_area: Tensor, g_area: Tensor, det_valid: Tensor, gt_valid: Tensor,
    thresholds: Tensor, area_ranges: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The scan of ``_per_group_from_iou`` in plain PyTorch, for all groups at once."""
    n, num_d, num_g = iou.shape
    num_a = area_ranges.shape[0]
    num_t = thresholds.shape[0]
    zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
    iou = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], iou, zero)
    lo = area_ranges[:, 0][None, :, None]
    hi = area_ranges[:, 1][None, :, None]
    g_ignore_area = (g_area[:, None, :] < lo) | (g_area[:, None, :] > hi)  # (N, A, G)
    invalid = ~gt_valid[:, None, :]
    # gts sorted ignored-last, as the scan permutes them (stable on the key)
    key = g_ignore_area.to(torch.int32) + 2 * invalid.to(torch.int32)
    perm = torch.sort(key, dim=-1, stable=True).indices
    full = (n, num_a, num_d, num_g)
    iou_p = torch.gather(iou[:, None].expand(full), 3, perm[:, :, None, :].expand(full))
    g_ignore = torch.gather(g_ignore_area | invalid, 2, perm)[:, :, None, :]  # (N, A, 1, G)

    slots = torch.arange(num_g, device=iou.device)
    gt_matches = torch.zeros((n, num_a, num_t, num_g), dtype=torch.bool, device=iou.device)
    det_matched = torch.zeros((n, num_a, num_t, num_d), dtype=torch.bool, device=iou.device)
    for d in range(num_d):
        cand = torch.where(gt_matches | g_ignore, zero, iou_p[:, :, d, None, :])  # (N, A, T, G)
        m = cand.argmax(dim=-1)
        best = torch.gather(cand, -1, m[..., None])[..., 0]
        matched = (best > thresholds) & det_valid[:, d, None, None]
        gt_matches |= (slots == m[..., None]) & matched[..., None]
        det_matched[..., d] = matched
    d_outside = (d_area[:, None, :] < lo) | (d_area[:, None, :] > hi)  # (N, A, D)
    det_ignored = (~det_matched & d_outside[:, :, None, :]) | ~det_valid[:, None, None, :]
    npig = (gt_valid[:, None, :] & ~g_ignore_area).sum(dim=-1, dtype=torch.int32)
    return det_matched, det_ignored, npig


def _check_inputs(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges) -> None:
    if iou.dim() != 3:
        raise ValueError(f"greedy match: iou must be (N, D, G), got shape {tuple(iou.shape)}")
    n, num_d, num_g = iou.shape
    num_t = thresholds.shape[0] if thresholds.dim() == 1 else -1
    num_a = area_ranges.shape[0] if area_ranges.dim() == 2 else -1
    expected = {
        "d_area": (d_area, (n, num_d), torch.float32), "g_area": (g_area, (n, num_g), torch.float32),
        "det_valid": (det_valid, (n, num_d), torch.bool), "gt_valid": (gt_valid, (n, num_g), torch.bool),
        "thresholds": (thresholds, (num_t,), torch.float32), "area_ranges": (area_ranges, (num_a, 2), torch.float32),
        "iou": (iou, (n, num_d, num_g), torch.float32),
    }
    for name, (x, shape, dtype) in expected.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"greedy match: {name} must be {dtype} of shape {shape}, got {x.dtype} of shape {tuple(x.shape)}"
            )
        if x.device != iou.device:
            raise ValueError(f"greedy match: {name} on {x.device}, iou on {iou.device}")
    if num_t == 0 or num_a == 0:
        raise ValueError("greedy match: needs at least one threshold and one area range")


class GreedyMatchKernel:
    """Wrapper of the CUDA greedy-match kernel: checks, launch, and a count of launches.

    ``launches`` grows by one each time the kernel is launched, and nowhere else.
    """

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = _build.load("greedy_match").tm_greedy_match
        return self._fn

    def __call__(self, iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges):
        """``(det_matched, det_ignored, npig)`` of CUDA inputs, as :func:`_plain_greedy_match`."""
        if iou.device.type != "cuda":
            raise ValueError(f"greedy match kernel: inputs must be CUDA tensors, got one on {iou.device}")
        _check_inputs(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)
        n, num_d, num_g = iou.shape
        if not 1 <= num_g <= KERNEL_MAX_G:
            raise ValueError(
                f"greedy match kernel: takes 1 to {KERNEL_MAX_G} ground truths per group, got {num_g}"
            )
        num_t, num_a = thresholds.shape[0], area_ranges.shape[0]
        matched = torch.empty((n, num_a, num_t, num_d), dtype=torch.bool, device=iou.device)
        ignored = torch.empty_like(matched)
        npig = torch.empty((n, num_a), dtype=torch.int32, device=iou.device)
        if n == 0:
            return matched, ignored, npig
        args = [x.contiguous() for x in (iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)]
        fn = self._function()
        err = _build.call_on_device(
            iou.device,
            lambda stream: fn(
                *(x.data_ptr() for x in args), n, num_d, num_g, num_t, num_a,
                matched.data_ptr(), ignored.data_ptr(), npig.data_ptr(), stream,
            ),
        )
        if err != 0:
            raise RuntimeError(f"greedy match kernel launch failed with CUDA error {err}")
        _build.note_launch(self)
        return matched, ignored, npig


greedy_match_cuda = GreedyMatchKernel()


def greedy_match(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges):
    """Greedy matching of every group at every area range and threshold.

    The kernel for CUDA inputs, the plain version for CPU inputs (the device of
    ``iou`` decides). Returns ``(det_matched, det_ignored, npig)``.
    """
    if _build.faking(iou):
        return tuple(torch.ops.metrics_tpu_torch.greedy_match(iou, d_area, g_area, det_valid, gt_valid, thresholds,
                                                              area_ranges))
    return _greedy_match_direct(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)


def _greedy_match_direct(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges):
    if iou.device.type == "cuda":
        return greedy_match_cuda(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)
    _check_inputs(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)
    return _plain_greedy_match(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)


@torch.library.custom_op("metrics_tpu_torch::greedy_match", mutates_args=())
def _greedy_match_op(iou: Tensor, d_area: Tensor, g_area: Tensor, det_valid: Tensor, gt_valid: Tensor,
                     thresholds: Tensor, area_ranges: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The greedy match as a custom op, so that a trace on fake tensors holds one node
    with the kernel's shapes (:func:`greedy_match` on real tensors)."""
    return _greedy_match_direct(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)


@_greedy_match_op.register_fake
def _greedy_match_fake(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges):
    _check_inputs(iou, d_area, g_area, det_valid, gt_valid, thresholds, area_ranges)
    n, num_d, _ = iou.shape
    num_t, num_a = thresholds.shape[0], area_ranges.shape[0]
    matched = iou.new_empty((n, num_a, num_t, num_d), dtype=torch.bool)
    return matched, torch.empty_like(matched), iou.new_empty((n, num_a), dtype=torch.int32)
