"""MeanAveragePrecision for object detection (counterpart of ``metrics_tpu/detection/mean_ap.py``).

The COCO protocol as the JAX package evaluates it, with the same routes:

- **Consolidated bbox states** (every update a ``(B, M, ...)`` padded batch) take
  the device path (:mod:`~metrics_tpu_torch.functional.detection._mean_ap_device`):
  grouping, two match launches and the PR tables on the states' device; one label
  fetch decides the classes and the bucket routing. Its tables are float64 (the JAX
  package's are float32), so both layouts give the same numbers where a recall
  lands on a recall threshold.
- **Otherwise** the states come to the host in one copy per dtype, the (image, class)
  groups are built there (``_build_groups``), one match launch runs on the states'
  device, and the PR tables are float64 numpy on the host.

The match is :func:`metrics_tpu_torch.ops.greedy_match.greedy_match`: the
hand-written kernel on the card, its plain version on the CPU. Differences from
pycocotools kept as in the JAX package: ignored ground truths are never matched (no
crowd fallback). ``iou_type="segm"`` takes dense binary masks or COCO RLE lists; the
mask IoU of an image is one float32 matmul of its 0/1 masks on the states' device,
with TF32 off (exact up to 2^24 pixels, as the JAX package's host numpy).
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.detection.helpers import (
    DetectionInputs,
    _fix_empty_tensors,
    _input_validator,
    _is_rle_list,
    _to_host,
    _validate_consolidated,
)
from metrics_tpu_torch.detection.rle import masks_from_rle
from metrics_tpu_torch.functional.detection._mean_ap_kernel import _match_groups, _match_groups_from_iou, _pow2
from metrics_tpu_torch.functional.detection.box_ops import box_convert
from metrics_tpu_torch.utils.compute import fp32_exact


class BaseMetricResults(dict):
    """Dict with attribute access for pre-defined result fields."""

    def __getattr__(self, key: str) -> Tensor:
        if key in self:
            return self[key]
        raise AttributeError(f"No such attribute: {key}")

    def __setattr__(self, key: str, value: Tensor) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        if key in self:
            del self[key]
            return
        raise AttributeError(f"No such attribute: {key}")


class MAPMetricResults(BaseMetricResults):
    """Final mAP results."""

    __slots__ = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "classes")


class MARMetricResults(BaseMetricResults):
    """Final mAR results."""

    __slots__ = ("mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large")


class COCOMetricResults(BaseMetricResults):
    """Full COCO-style result set."""

    __slots__ = (
        "map", "map_50", "map_75", "map_small", "map_medium", "map_large",
        "mar_1", "mar_10", "mar_100", "mar_small", "mar_medium", "mar_large",
        "map_per_class", "mar_100_per_class",
    )


_EPS = float(np.finfo(np.float64).eps)


def _pad_rows(entries: Sequence[Tensor], width: int, fill) -> Tensor:
    """Concatenate ``(B_i, M_i, ...)`` entries along dim 0, each padded with ``fill``
    along dim 1 to ``max(width, max M_i)``."""
    width = max([width] + [int(e.shape[1]) for e in entries])
    out = []
    for e in entries:
        if e.shape[1] < width:
            padded = torch.full((e.shape[0], width, *e.shape[2:]), fill, dtype=e.dtype, device=e.device)
            padded[:, : e.shape[1]] = e
            e = padded
        out.append(e)
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


class MeanAveragePrecision(DetectionInputs, Metric):
    r"""Compute Mean Average Precision / Recall for object detection predictions.

    Follows the COCO evaluation protocol. ``preds`` is a list of per-image dicts with
    ``boxes`` (N, 4), ``scores`` (N,) and ``labels`` (N,); ``target`` dicts carry
    ``boxes`` and ``labels``. ``compute`` returns the COCO result dict.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [dict(
        ...     boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...     scores=torch.tensor([0.536]),
        ...     labels=torch.tensor([0]),
        ... )]
        >>> target = [dict(
        ...     boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...     labels=torch.tensor([0]),
        ... )]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result['map']), 4), round(float(result['map_50']), 4)
        (0.6, 1.0)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, round((0.95 - 0.5) / 0.05) + 1).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, round(1.00 / 0.01) + 1).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"Expected argument `iou_type` to be 'bbox' or 'segm', got {iou_type!r}")
        self.iou_type = iou_type
        self.bbox_area_ranges = {
            "all": (float(0**2), float(1e5**2)),
            "small": (float(0**2), float(32**2)),
            "medium": (float(32**2), float(96**2)),
            "large": (float(96**2), float(1e5**2)),
        }

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        self.add_state("detections", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruths", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)

    def update(self, preds, target) -> None:
        """Append detections and ground truths to the unreduced states.

        Two input layouts are accepted:

        - **List layout**: lists of per-image dicts. ``masks`` may also be a per-image
          list of COCO RLE dicts (``{"size": [h, w], "counts": ...}``, compressed or
          not), decoded on the host by :mod:`metrics_tpu_torch.detection.rle`.
        - **Consolidated layout**: single dicts of batched padded arrays,
          ``preds = {"boxes": (B, M, 4), "scores": (B, M), "labels": (B, M)}``
          (``"masks": (B, M, H, W)`` for segm), ``target`` likewise without scores;
          rows with ``labels < 0`` are padding. Each update appends one entry per
          state, whatever B is.
        """
        if isinstance(preds, dict) and isinstance(target, dict):
            _validate_consolidated(preds, target, iou_type=self.iou_type)
            key = "masks" if self.iou_type == "segm" else "boxes"
            self.detections.append(preds[key])
            self.detection_scores.append(preds["scores"])
            self.detection_labels.append(preds["labels"])
            self.groundtruths.append(target[key])
            self.groundtruth_labels.append(target["labels"])
            return

        _input_validator(preds, target, iou_type=self.iou_type)

        for item in preds:
            self.detections.append(self._get_safe_item_values(item))
            self.detection_labels.append(item["labels"].reshape(-1))
            self.detection_scores.append(item["scores"].reshape(-1))

        for item in target:
            self.groundtruths.append(self._get_safe_item_values(item))
            self.groundtruth_labels.append(item["labels"].reshape(-1))

    def _get_safe_item_values(self, item: Dict[str, Any]) -> Tensor:
        if self.iou_type == "segm":
            if _is_rle_list(item["masks"]):
                # COCO-annotation ingestion: decoded on the host to the dense form
                return torch.from_numpy(masks_from_rle(item["masks"])).to(self.device)
            masks = item["masks"]
            if masks.numel() == 0:
                return torch.zeros((0, 1, 1), dtype=torch.bool, device=masks.device)
            return masks.to(torch.bool)
        boxes = _fix_empty_tensors(item["boxes"])
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _fetch_host_states(self):
        """The five state lists on the host, per image.

        Scores, labels and boxes come over in one copy per dtype; masks stay on the
        states' device, where their IoU is computed. Consolidated entries (one extra
        leading dim) expand to per-image arrays with their padding rows (labels < 0)
        dropped and their boxes converted to xyxy.
        """
        host = [_to_host(list(x)) for x in (self.detection_scores, self.detection_labels, self.groundtruth_labels)]
        if self.iou_type == "segm":
            det, gt = list(self.detections), list(self.groundtruths)
        else:
            det, gt = _to_host(list(self.detections)), _to_host(list(self.groundtruths))
        return self._expand_consolidated((det, host[0], host[1], gt, host[2]))

    def _expand_consolidated(self, host):
        """Split batched ``(B, M, ...)`` state entries into per-image entries."""
        det, ds, dl, gt, gl = (list(x) for x in host)
        item_ndim = 3 if self.iou_type == "segm" else 2  # per-image (n, H, W) / (n, 4)

        def expand(items, labels, *extra_streams):
            """One rule for preds and gts: gts are just preds minus the scores stream."""
            outs = [[] for _ in range(2 + len(extra_streams))]
            for entry in zip(items, labels, *extra_streams):
                item, lab = entry[0], entry[1]
                if item.ndim == item_ndim:
                    for out, v in zip(outs, entry):
                        out.append(v)
                    continue
                for b in range(len(lab)):
                    keep = lab[b] >= 0
                    if isinstance(item, Tensor):
                        rows = item[b][torch.from_numpy(keep).to(item.device)]
                    else:
                        rows = item[b][keep]
                        if self.box_format != "xyxy" and rows.size:
                            rows = box_convert(torch.from_numpy(rows), in_fmt=self.box_format, out_fmt="xyxy").numpy()
                    outs[0].append(rows)
                    outs[1].append(lab[b][keep])
                    for out, stream in zip(outs[2:], entry[2:]):
                        out.append(stream[b][keep])
            return outs

        det, dl, ds = expand(det, dl, ds)
        gt, gl = expand(gt, gl)
        return det, ds, dl, gt, gl

    def _get_classes(self, host=None) -> List:
        """Unique classes present in detections or ground truth."""
        if len(self.detection_labels) > 0 or len(self.groundtruth_labels) > 0:
            if host is None:
                host = self._fetch_host_states()
            labels = [np.asarray(x).reshape(-1) for x in list(host[2]) + list(host[4])]
            cat = np.concatenate(labels) if labels else np.zeros(0)
            return sorted(np.unique(cat).astype(np.int64).tolist()) if cat.size else []
        return []

    # ------------------------------------------------------------- evaluation

    @staticmethod
    def _image_mask_iou(d_all: Tensor, g_all: Tensor):
        """Per image: detection and gt mask areas, and their IoU matrix where the
        spatial sizes agree (None otherwise), on the host as float32."""
        d_pix = int(np.prod(d_all.shape[1:]))
        g_pix = int(np.prod(g_all.shape[1:]))
        df = d_all.reshape(d_all.shape[0], d_pix).to(torch.bool).to(torch.float32)
        gf = g_all.reshape(g_all.shape[0], g_pix).to(torch.bool).to(torch.float32)
        d_area = df.sum(1)
        g_area = gf.sum(1)
        iou = None
        if d_pix == g_pix:
            with fp32_exact():
                inter = df @ gf.T
            # binary masks -> integer-valued union; the clamp covers the both-empty
            # case (iou 0 there since inter is 0)
            union = d_area[:, None] + g_area[None, :] - inter
            iou = (inter / torch.clamp(union, min=1.0)).cpu().numpy()
        return iou, d_area.cpu().numpy(), g_area.cpu().numpy()

    def _build_groups(self, class_ids: List[int], host=None):
        """Collect non-empty (image, class) evaluation groups as host arrays."""
        max_det = self.max_detection_thresholds[-1]
        if host is None:
            host = self._fetch_host_states()
        segm = self.iou_type == "segm"
        if not segm:
            det_items = [np.asarray(b, np.float32).reshape(-1, 4) for b in host[0]]
            gt_items = [np.asarray(b, np.float32).reshape(-1, 4) for b in host[3]]
        det_scores_np = [np.asarray(s, np.float32).reshape(-1) for s in host[1]]
        det_labels_np = [np.asarray(lab).reshape(-1) for lab in host[2]]
        gt_labels_np = [np.asarray(lab).reshape(-1) for lab in host[4]]

        groups = []  # bbox: (k_idx, det_boxes, det_scores, gt_boxes)
        #             segm: (k_idx, iou, d_area, det_scores, g_area)
        for img in range(len(gt_labels_np)):
            image_iou = None
            for k_idx, cls in enumerate(class_ids):
                dmask = det_labels_np[img] == cls if img < len(det_labels_np) else np.zeros(0, bool)
                gmask = gt_labels_np[img] == cls
                if not dmask.any() and not gmask.any():
                    continue
                ds = det_scores_np[img][dmask]
                order = np.argsort(-ds, kind="stable")[:max_det]
                if segm:
                    if image_iou is None:
                        image_iou = self._image_mask_iou(host[0][img], host[3][img])
                    full_iou, d_area_all, g_area_all = image_iou
                    d_pix = int(np.prod(host[0][img].shape[1:]))
                    g_pix = int(np.prod(host[3][img].shape[1:]))
                    d_area = d_area_all[dmask][order]
                    g_area = g_area_all[gmask]
                    if len(order) * d_pix and int(gmask.sum()) * g_pix:
                        if d_pix != g_pix:
                            raise ValueError(
                                f"prediction and target masks of image {img} have different"
                                f" spatial sizes ({d_pix} vs {g_pix} pixels)"
                            )
                        iou = full_iou[dmask][order][:, gmask]
                    else:
                        iou = np.zeros((len(order), int(gmask.sum())), np.float32)
                    groups.append((k_idx, iou.astype(np.float32), d_area, ds[order], g_area))
                else:
                    db = det_items[img][dmask]
                    groups.append((k_idx, db[order], ds[order], gt_items[img][gmask]))
        return groups

    def _device_path_ok(self) -> bool:
        """True when every state entry came from the consolidated bbox layout."""
        if self.iou_type != "bbox" or not len(self.detections):
            return False
        return all(x.dim() == 3 for x in self.detections) and all(x.dim() == 3 for x in self.groundtruths)

    def _area_ranges(self) -> Tensor:
        return torch.tensor(list(self.bbox_area_ranges.values()), dtype=torch.float32, device=self.device)

    def _calculate_device(self):
        """Classes and device-resident tables for consolidated states (bbox only).

        Returns ``(classes, precision, recall)``; one label fetch decides the class
        list and the bucket routing, everything else stays on the states' device.
        """
        from metrics_tpu_torch.functional.detection._mean_ap_device import consolidated_tables, plan_buckets

        max_det = self.max_detection_thresholds[-1]
        d_small = g_small = 16
        det_labels = _pad_rows(list(self.detection_labels), d_small, -1).to(torch.int64)
        gt_labels = _pad_rows(list(self.groundtruth_labels), g_small, -1).to(torch.int64)
        dl_np, gl_np = _to_host([det_labels, gt_labels])
        cat = np.concatenate([dl_np.reshape(-1), gl_np.reshape(-1)])
        cat = cat[cat >= 0]
        class_ids = sorted(np.unique(cat).astype(np.int64).tolist()) if cat.size else []
        class_ids_np = np.asarray(class_ids, np.int64)
        K = len(class_ids_np)
        if K == 0:
            num_t, num_r = len(self.iou_thresholds), len(self.rec_thresholds)
            num_a, num_m = len(self.bbox_area_ranges), len(self.max_detection_thresholds)
            return [], -np.ones((num_t, num_r, 0, num_a, num_m)), -np.ones((num_t, 0, num_a, num_m))
        det_counts = (dl_np[:, :, None] == class_ids_np[None, None, :]).sum(1)  # (B, K)
        gt_counts = (gl_np[:, :, None] == class_ids_np[None, None, :]).sum(1)
        is_small, big_pairs, d_big, g_big = plan_buckets(det_counts, gt_counts, max_det)

        nb = _pow2(max(1, len(big_pairs)))
        big_b = np.zeros(nb, np.int64)
        big_kidx = np.full(nb, -1, np.int64)
        for i, (b, kidx) in enumerate(big_pairs):
            big_b[i] = b
            big_kidx[i] = kidx
        big_k = np.where(big_kidx >= 0, class_ids_np[np.maximum(big_kidx, 0)], -1)

        det_boxes = _pad_rows(list(self.detections), max(d_small, d_big), 0.0).to(torch.float32)
        det_scores = _pad_rows(list(self.detection_scores), max(d_small, d_big), float("-inf")).to(torch.float32)
        gt_boxes = _pad_rows(list(self.groundtruths), max(g_small, g_big), 0.0).to(torch.float32)
        # labels were padded before the bucket widths were known; pad again so that
        # every buffer shares one (B, width)
        det_labels = _pad_rows([det_labels], det_boxes.shape[1], -1)
        gt_labels = _pad_rows([gt_labels], gt_boxes.shape[1], -1)
        if self.box_format != "xyxy":
            det_boxes = box_convert(det_boxes, in_fmt=self.box_format, out_fmt="xyxy")
            gt_boxes = box_convert(gt_boxes, in_fmt=self.box_format, out_fmt="xyxy")

        dev = self.device
        precision, recall = consolidated_tables(
            det_boxes,
            det_scores,
            det_labels,
            gt_boxes,
            gt_labels,
            torch.from_numpy(class_ids_np).to(dev),
            torch.from_numpy(is_small).to(dev),
            torch.from_numpy(big_b).to(dev),
            torch.from_numpy(big_k).to(dev),
            torch.from_numpy(big_kidx).to(dev),
            torch.tensor(self.iou_thresholds, dtype=torch.float32, device=dev),
            torch.tensor(self.rec_thresholds, dtype=torch.float64, device=dev),
            self._area_ranges(),
            d_small=d_small,
            g_small=g_small,
            d_big=d_big,
            g_big=g_big,
            max_det=max_det,
            # the cap only truncates REAL rows (padding slots are ignored either
            # way), so rank < m is the host path's min(m, width) semantics
            caps=tuple(self.max_detection_thresholds),
        )
        precision, recall = _to_host([precision.contiguous(), recall.contiguous()])
        return class_ids, precision, recall

    def _calculate(self, class_ids: List[int], host=None) -> Tuple[np.ndarray, np.ndarray]:
        """Precision/recall tables over (T, R, K, A, M): one match launch, host PR tables."""
        num_t = len(self.iou_thresholds)
        num_r = len(self.rec_thresholds)
        num_k = len(class_ids)
        num_a = len(self.bbox_area_ranges)
        num_m = len(self.max_detection_thresholds)
        precision = -np.ones((num_t, num_r, num_k, num_a, num_m))
        recall = -np.ones((num_t, num_k, num_a, num_m))

        groups = self._build_groups(class_ids, host=host)
        if not groups:
            return precision, recall

        ng = len(groups)
        pad_n = _pow2(ng)
        group_cls = np.zeros(ng, np.int64)

        def pack(shape_tail, dtype=np.float32, fill=0.0):
            return np.full((pad_n, *shape_tail), fill, dtype)

        pad_d = _pow2(max(1, max(g[1].shape[0] for g in groups)))
        n_gt = 4 if self.iou_type == "segm" else 3
        pad_g = _pow2(max(1, max(g[n_gt].shape[0] for g in groups)))
        det_scores = pack((pad_d,), fill=-np.inf)
        det_valid = pack((pad_d,), bool, False)
        gt_valid = pack((pad_g,), bool, False)
        dev = self.device
        thresholds = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=dev)
        to_dev = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731

        if self.iou_type == "segm":
            iou = pack((pad_d, pad_g))
            d_area = pack((pad_d,))
            g_area = pack((pad_g,))
            for i, (k_idx, giou, da, ds, ga) in enumerate(groups):
                group_cls[i] = k_idx
                iou[i, : giou.shape[0], : giou.shape[1]] = giou
                d_area[i, : da.shape[0]] = da
                g_area[i, : ga.shape[0]] = ga
                det_scores[i, : ds.shape[0]] = ds
                det_valid[i, : da.shape[0]] = True
                gt_valid[i, : ga.shape[0]] = True
            out = _match_groups_from_iou(
                to_dev(iou), to_dev(d_area), to_dev(g_area), to_dev(det_valid), to_dev(gt_valid),
                thresholds, self._area_ranges(),
            )
        else:
            det_boxes = pack((pad_d, 4))
            gt_boxes = pack((pad_g, 4))
            for i, (k_idx, db, ds, gb) in enumerate(groups):
                group_cls[i] = k_idx
                det_boxes[i, : db.shape[0]] = db
                det_scores[i, : ds.shape[0]] = ds
                det_valid[i, : db.shape[0]] = True
                gt_boxes[i, : gb.shape[0]] = gb
                gt_valid[i, : gb.shape[0]] = True
            out = _match_groups(
                to_dev(det_boxes), to_dev(det_valid), to_dev(gt_boxes), to_dev(gt_valid),
                thresholds, self._area_ranges(),
            )
        det_matched, det_ignored, npig_ga = _to_host(list(out))
        det_matched = det_matched[:ng]   # (ng, A, T, D)
        det_ignored = det_ignored[:ng]
        npig_ga = npig_ga[:ng]           # (ng, A)

        rec_thresholds = np.asarray(self.rec_thresholds)
        for k_idx in range(num_k):
            sel = np.nonzero(group_cls == k_idx)[0]
            if sel.size == 0:
                continue
            valid_k, scores_k = det_valid[sel], det_scores[sel]
            matched_k, ignored_k = det_matched[sel], det_ignored[sel]
            for a_idx in range(num_a):
                npig = int(npig_ga[sel, a_idx].sum())
                if npig == 0:
                    continue
                for m_idx, max_det in enumerate(self.max_detection_thresholds):
                    cap = min(max_det, det_scores.shape[1])
                    # padding slots are ignored rows scored -inf: dropped before the sort,
                    # they change no table entry (the JAX package sorts them along)
                    keep = valid_k[:, :cap].reshape(-1)
                    scores_flat = scores_k[:, :cap].reshape(-1)[keep]
                    matched = matched_k[:, a_idx, :, :cap].transpose(1, 0, 2).reshape(num_t, -1)[:, keep]
                    ignored = ignored_k[:, a_idx, :, :cap].transpose(1, 0, 2).reshape(num_t, -1)[:, keep]

                    order = np.argsort(-scores_flat, kind="stable")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = np.cumsum(matched & ~ignored, axis=1, dtype=np.float64)
                    fps = np.cumsum(~matched & ~ignored, axis=1, dtype=np.float64)
                    nd = tps.shape[1]
                    rc = tps / npig
                    pr = tps / (fps + tps + _EPS)
                    recall[:, k_idx, a_idx, m_idx] = rc[:, -1] if nd else 0.0

                    # precision envelope: running max from the right
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]

                    for t_idx in range(num_t):
                        inds = np.searchsorted(rc[t_idx], rec_thresholds, side="left")
                        num_inds = int(inds.argmax()) if inds.max() >= nd else num_r
                        prec = np.zeros(num_r)
                        prec[:num_inds] = pr[t_idx][inds[:num_inds]]
                        precision[t_idx, :, k_idx, a_idx, m_idx] = prec

        return precision, recall

    # ------------------------------------------------------------- summaries

    def _summarize(
        self,
        results: Dict[str, np.ndarray],
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> Tensor:
        """Mean over valid (> -1) table entries for one view."""
        area_inds = [i for i, k in enumerate(self.bbox_area_ranges.keys()) if k == area_range]
        mdet_inds = [i for i, k in enumerate(self.max_detection_thresholds) if k == max_dets]
        if avg_prec:
            prec = results["precision"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, :, area_inds, mdet_inds]
        else:
            prec = results["recall"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, area_inds, mdet_inds]
        valid = prec[prec > -1]
        if valid.size == 0:
            return torch.tensor([-1.0], device=self.device)
        return torch.tensor(valid.mean(), dtype=torch.float32, device=self.device)

    def _summarize_results(self, precisions: np.ndarray, recalls: np.ndarray) -> Tuple[MAPMetricResults, MARMetricResults]:
        """COCO summary table from precision/recall tables."""
        results = {"precision": precisions, "recall": recalls}
        map_metrics = MAPMetricResults()
        last_max_det_thr = self.max_detection_thresholds[-1]
        map_metrics.map = self._summarize(results, True, max_dets=last_max_det_thr)
        if 0.5 in self.iou_thresholds:
            map_metrics.map_50 = self._summarize(results, True, iou_threshold=0.5, max_dets=last_max_det_thr)
        else:
            map_metrics.map_50 = torch.tensor([-1.0], device=self.device)
        if 0.75 in self.iou_thresholds:
            map_metrics.map_75 = self._summarize(results, True, iou_threshold=0.75, max_dets=last_max_det_thr)
        else:
            map_metrics.map_75 = torch.tensor([-1.0], device=self.device)
        map_metrics.map_small = self._summarize(results, True, area_range="small", max_dets=last_max_det_thr)
        map_metrics.map_medium = self._summarize(results, True, area_range="medium", max_dets=last_max_det_thr)
        map_metrics.map_large = self._summarize(results, True, area_range="large", max_dets=last_max_det_thr)

        mar_metrics = MARMetricResults()
        for max_det in self.max_detection_thresholds:
            mar_metrics[f"mar_{max_det}"] = self._summarize(results, False, max_dets=max_det)
        mar_metrics.mar_small = self._summarize(results, False, area_range="small", max_dets=last_max_det_thr)
        mar_metrics.mar_medium = self._summarize(results, False, area_range="medium", max_dets=last_max_det_thr)
        mar_metrics.mar_large = self._summarize(results, False, area_range="large", max_dets=last_max_det_thr)

        return map_metrics, mar_metrics

    def compute(self) -> dict:
        """Full COCO result dict from the accumulated detections."""
        if self._device_path_ok():
            classes, precisions, recalls = self._calculate_device()
        else:
            host = self._fetch_host_states()
            classes = self._get_classes(host=host)
            precisions, recalls = self._calculate(classes, host=host)
        map_val, mar_val = self._summarize_results(precisions, recalls)

        map_per_class_values: Tensor = torch.tensor([-1.0], device=self.device)
        mar_max_dets_per_class_values: Tensor = torch.tensor([-1.0], device=self.device)
        if self.class_metrics:
            map_per_class_list = []
            mar_max_dets_per_class_list = []
            for class_idx, _ in enumerate(classes):
                cls_precisions = precisions[:, :, class_idx][:, :, None]
                cls_recalls = recalls[:, class_idx][:, None]
                cls_map, cls_mar = self._summarize_results(cls_precisions, cls_recalls)
                map_per_class_list.append(cls_map.map)
                mar_max_dets_per_class_list.append(cls_mar[f"mar_{self.max_detection_thresholds[-1]}"])
            map_per_class_values = torch.stack([x.reshape(-1)[0] for x in map_per_class_list]) if classes else (
                torch.zeros(0, device=self.device)
            )
            mar_max_dets_per_class_values = torch.stack(
                [x.reshape(-1)[0] for x in mar_max_dets_per_class_list]
            ) if classes else torch.zeros(0, device=self.device)

        metrics = COCOMetricResults()
        metrics.update(map_val)
        metrics.update(mar_val)
        metrics.map_per_class = map_per_class_values
        metrics[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = mar_max_dets_per_class_values
        metrics.classes = torch.tensor(classes, dtype=torch.int32, device=self.device)
        return metrics
