"""Device-resident mAP evaluation for consolidated inputs (counterpart of
``metrics_tpu/functional/detection/_mean_ap_device.py``).

For the consolidated layout (updates of ``(B, M, ...)`` padded batches), everything
from grouping to the 101-point PR tables runs on the states' device, and only the
result tables come back to the host:

1. **Grouping is a batched stable sort**: for each class, each image's rows are
   ordered by ``(label != k, -score)``, so the class's detections land score-sorted
   in the leading slots (the reference's ``argsort(-scores, stable)[:max_det]``).
2. **Two-bucket matching**: groups with at most 16 detections and 16 ground truths
   go to one ``(K*B, 16, 16)`` match launch, the rest to one launch at power-of-two
   widths; the routing is decided on the host from the labels.
3. **PR accumulation on the device**, one class at a time (the JAX ``lax.map`` as a
   Python loop): the class's row slots sorted by score, cumsums of the 0/1 TP and FP
   streams, the reverse cummax envelope and the 101-recall lookup by
   ``searchsorted(side="left")``.

Two deliberate deviations from the JAX device tables keep the two layouts equal:

- **Tied scores are ordered by (image, slot)**, as the list layout's stable sort of
  the per-image rows orders them. The JAX package sorts every small-bucket row
  before every big-bucket row, so a tie between an image with a big group and a later
  image with a small one resolves the other way there, and its two layouts differ.
- **The tables are float64**, where the JAX package's are float32. A recall that
  lands on a threshold (7 of 20 ground truths, 0.35) is ``0.35f == float32(0.35)`` in
  float32 but stays below the float64 ``np.linspace`` threshold
  ``0.35000000000000003``, so float32 tables look up another precision than the host
  path's float64 ones, by up to ~1e-3 for a class. In float64 every division and
  comparison is the host path's.
"""
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.detection._mean_ap_kernel import _match_groups_core
from metrics_tpu_torch.utils.data import _next_pow2

_EPS = float(np.finfo(np.float64).eps)


def _take_rows(x: Tensor, perm: Tensor) -> Tensor:
    """``x[..., perm, :]`` along the row axis of ``(..., M)`` or ``(..., M, 4)`` inputs."""
    if x.dim() == perm.dim():
        return torch.gather(x, -1, perm)
    return torch.gather(x, -2, perm[..., None].expand(*perm.shape, x.shape[-1]))


def _group_rows(boxes, scores, labels, class_vec, width, max_det):
    """Score-sorted class rows for each (group, class) pair.

    ``boxes/scores/labels`` are ``(..., N, M, ...)`` image rows; ``class_vec`` is the
    class id each output group selects, broadcast against the labels' leading dims.
    Returns ``(..., N, width)`` slots: the class's detections score-sorted first
    (stable ties keep input order), padding after; ``valid`` marks real class rows
    within the top ``max_det``.
    """
    is_class = labels == class_vec[..., None]
    key = torch.where(is_class, -scores, torch.full((), float("inf"), device=scores.device))
    perm = torch.sort(key, dim=-1, stable=True).indices[..., :width]
    b = _take_rows(boxes.expand(*perm.shape[:-1], *boxes.shape[-2:]), perm)
    s = _take_rows(scores.expand(*perm.shape[:-1], scores.shape[-1]), perm)
    valid = _take_rows(is_class, perm)
    valid = valid & (torch.arange(perm.shape[-1], device=perm.device) < max_det)
    return b, s, valid


def _group_gt_rows(boxes, labels, class_vec, width):
    """Class ground-truth rows packed first (original order preserved)."""
    is_class = labels == class_vec[..., None]
    perm = torch.sort((~is_class).to(torch.uint8), dim=-1, stable=True).indices[..., :width]
    b = _take_rows(boxes.expand(*perm.shape[:-1], *boxes.shape[-2:]), perm)
    valid = _take_rows(is_class, perm)
    return b, valid


def consolidated_tables(
    det_boxes: Tensor,   # (B, M, 4) xyxy
    det_scores: Tensor,  # (B, M); padding rows score -inf
    det_labels: Tensor,  # (B, M) int; padding rows < 0
    gt_boxes: Tensor,    # (B, Mg, 4)
    gt_labels: Tensor,   # (B, Mg) int; padding rows < 0
    class_arr: Tensor,   # (K,) sorted unique class ids
    is_small: Tensor,    # (B, K) bool: group (b, k) routed to the small bucket
    big_b: Tensor,       # (Nb,) image index of each big group (0 for dummies)
    big_k: Tensor,       # (Nb,) class id of each big group (-1 for dummies)
    big_kidx: Tensor,    # (Nb,) index into class_arr (-1 for dummies)
    iou_thresholds: Tensor,  # (T,) float32
    rec_thresholds: Tensor,  # (R,) float64
    area_ranges: Tensor,     # (A, 2) float32
    *,
    d_small: int,
    g_small: int,
    d_big: int,
    g_big: int,
    max_det: int,
    caps: Tuple[int, ...],
) -> Tuple[Tensor, Tensor]:
    """Precision ``(T, R, K, A, M)`` and recall ``(T, K, A, M)`` tables on the device."""
    device = det_boxes.device
    B, K = is_small.shape
    num_t = iou_thresholds.shape[0]
    num_a = area_ranges.shape[0]
    num_m = len(caps)

    # ---- small bucket: dense (K, B) grid of groups at narrow widths ------------
    class_col = class_arr[:, None]  # (K, 1): broadcasts over the images
    s_db, s_ds, s_dv = _group_rows(det_boxes[None], det_scores[None], det_labels[None], class_col, d_small, max_det)
    s_gb, s_gv = _group_gt_rows(gt_boxes[None], gt_labels[None], class_col, g_small)
    small_k = is_small.T[:, :, None]  # (K, B, 1)
    s_dv = s_dv & small_k
    s_gv = s_gv & small_k
    flat = lambda x: x.reshape((K * B,) + tuple(x.shape[2:]))  # noqa: E731
    s_matched, s_ignored, s_npig = _match_groups_core(
        flat(s_db), flat(s_dv), flat(s_gb), flat(s_gv), iou_thresholds, area_ranges
    )  # (K*B, A, T, d_small), ..., (K*B, A)
    s_matched = s_matched.reshape(K, B, num_a, num_t, d_small)
    s_ignored = s_ignored.reshape(K, B, num_a, num_t, d_small)
    s_npig = s_npig.reshape(K, B, num_a)
    s_scores = s_ds  # (K, B, d_small)

    # ---- big bucket: host-listed (b, k) groups at wide static widths -----------
    nb = big_b.shape[0]
    b_db, b_ds, b_dv = _group_rows(det_boxes[big_b], det_scores[big_b], det_labels[big_b], big_k, d_big, max_det)
    b_gb, b_gv = _group_gt_rows(gt_boxes[big_b], gt_labels[big_b], big_k, g_big)
    # dummy groups carry class -1, which matches padding label rows: mask them out
    real = (big_k >= 0)[:, None]
    b_dv = b_dv & real
    b_gv = b_gv & real
    b_matched, b_ignored, b_npig = _match_groups_core(
        b_db, b_dv, b_gb, b_gv, iou_thresholds, area_ranges
    )  # (Nb, A, T, d_big), ..., (Nb, A)

    # per-class npig: small grid sum + big groups folded in by class index
    npig = s_npig.sum(dim=1, dtype=torch.int32)  # (K, A)
    npig = npig.index_add(0, big_kidx.clamp(min=0).long(), b_npig * (big_kidx >= 0)[:, None].to(torch.int32))

    caps_arr = torch.tensor(caps, dtype=torch.int32, device=device)  # (M,)
    num_r = rec_thresholds.shape[0]
    rank = torch.cat([
        torch.arange(d_small, device=device).repeat(B),
        torch.arange(d_big, device=device).repeat(nb),
    ])
    # rows in (image, slot) order, so the stable score sort below breaks ties as the list layout does
    image = torch.cat([torch.arange(B, device=device).repeat_interleave(d_small), big_b.repeat_interleave(d_big)])
    by_image = torch.sort(image * max(d_small, d_big) + rank, stable=True).indices
    rank = rank[by_image]
    small_rows = lambda x: x.permute(0, 3, 1, 2).reshape(B * d_small, num_a, num_t)  # noqa: E731
    big_rows = b_matched.permute(0, 3, 1, 2).reshape(nb * d_big, num_a, num_t)
    big_ignored = b_ignored.permute(0, 3, 1, 2).reshape(nb * d_big, num_a, num_t)
    big_owner = big_kidx.repeat_interleave(d_big)  # (nb * d_big,)
    neg_inf = torch.full((), float("-inf"), device=device)

    # ---- PR accumulation: one class at a time (bounds peak memory) -------------
    precision = torch.empty((K, num_a, num_t, num_m, num_r), dtype=torch.float64, device=device)
    recall = torch.empty((K, num_a, num_t, num_m), dtype=torch.float64, device=device)
    for kidx in range(K):
        # rows = the class's small grid slots + every big-bucket slot masked to it
        mine = big_owner == kidx
        sc = torch.cat([s_scores[kidx].reshape(-1), torch.where(mine, b_ds.reshape(-1), neg_inf)])[by_image]
        m_rows = torch.cat([small_rows(s_matched[kidx]), big_rows])[by_image]  # (R, A, T)
        i_rows = torch.cat([small_rows(s_ignored[kidx]), big_ignored | ~mine[:, None, None]])[by_image]

        order = torch.sort(-sc, stable=True).indices
        incap = rank[order][:, None] < caps_arr[None, :]  # (R, M)
        m_rows = m_rows[order]
        counted = ~i_rows[order]
        # (A, T, M, R) streams of 0/1 summands: exact float64 cumsums
        tp = (m_rows & counted)[:, :, :, None] & incap[:, None, None, :]
        fp = (~m_rows & counted)[:, :, :, None] & incap[:, None, None, :]
        tps = torch.cumsum(tp.permute(1, 2, 3, 0).to(torch.float64), dim=-1)
        fps = torch.cumsum(fp.permute(1, 2, 3, 0).to(torch.float64), dim=-1)

        npig_k = npig[kidx].to(torch.float64)  # (A,)
        rc = tps / torch.clamp(npig_k[:, None, None, None], min=1.0)
        pr = tps / (tps + fps + _EPS)
        rec_last = rc[..., -1]  # (A, T, M)
        pr_env = torch.flip(torch.cummax(torch.flip(pr, (-1,)), dim=-1).values, (-1,))

        n_rows = rc.shape[-1]
        flat_rc = rc.reshape(-1, n_rows).contiguous()
        inds = torch.searchsorted(flat_rc, rec_thresholds.expand(flat_rc.shape[0], num_r).contiguous(), side="left")
        flat_env = pr_env.reshape(-1, n_rows)
        prec = torch.where(
            inds < n_rows,
            torch.gather(flat_env, -1, torch.clamp(inds, max=n_rows - 1)),
            torch.zeros((), dtype=torch.float64, device=device),
        ).reshape(num_a, num_t, num_m, num_r)

        # npig == 0 keeps the reference's -1 sentinel for "no gts in this slice"
        valid = npig[kidx] > 0  # (A,)
        minus_one = torch.full((), -1.0, dtype=torch.float64, device=device)
        precision[kidx] = torch.where(valid[:, None, None, None], prec, minus_one)
        recall[kidx] = torch.where(valid[:, None, None], rec_last, minus_one)

    return precision.permute(2, 4, 0, 1, 3), recall.permute(2, 0, 1, 3)  # (T, R, K, A, M), (T, K, A, M)


def plan_buckets(det_counts: np.ndarray, gt_counts: np.ndarray, max_det: int):
    """Host-side bucket routing from per-(image, class) row counts.

    Returns ``(is_small (B, K) bool, big_pairs list[(b, kidx)], d_big, g_big)`` with
    pow2 widths; ``d_small``/``g_small`` are fixed at 16, as in the JAX package.
    """
    small_cap = 16
    is_small = (det_counts <= small_cap) & (gt_counts <= small_cap)
    big_idx = np.nonzero(~is_small)
    big_pairs = list(zip(big_idx[0].tolist(), big_idx[1].tolist()))
    if big_pairs:
        d_big = _next_pow2(int(min(max(det_counts[~is_small].max(), 1), max_det)))
        g_big = _next_pow2(int(max(gt_counts[~is_small].max(), 1)))
        d_big = max(d_big, 1)
    else:
        d_big, g_big = 1, 1
    return is_small, big_pairs, d_big, g_big
