"""Shared panoptic-quality machinery (counterpart of
``metrics_tpu/functional/detection/_panoptic_quality_common.py``).

Per sample, the segments are relabelled to dense ids on the device
(``torch.unique(return_inverse=True)`` of the packed ``(category, instance)`` keys,
where the JAX package uses host ``np.unique``), and everything after that is one
``(num_pred_segments, num_target_segments)`` intersection matrix built by one
histogram of the pair ids, through ``utils/data._bincount``: the hand-written
histogram kernel in count mode where ``num_p * num_t <= 2^14``, its plain version
above that, as for every other caller. Matching, TP, FP and FN are vectorised masks
over that matrix. ``iou_sum`` is float64 (the JAX package's is float64 only under
``jax_enable_x64``); the counts are int32.
"""
from typing import Collection, Dict, Optional, Set, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import _bincount, to_tensor
from metrics_tpu_torch.utils.prints import rank_zero_warn

_Color = Tuple[int, int]
_ENC = 1 << 32  # (category, instance) -> category * 2^32 + instance


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate the ``things``/``stuffs`` category sets."""
    things_parsed = set(things)
    if len(things_parsed) < len(things):
        rank_zero_warn("The provided `things` categories contained duplicates, which have been removed.", UserWarning)
    stuffs_parsed = set(stuffs)
    if len(stuffs_parsed) < len(stuffs):
        rank_zero_warn("The provided `stuffs` categories contained duplicates, which have been removed.", UserWarning)
    if not all(isinstance(val, int) for val in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(val, int) for val in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    """Shape validation."""
    if preds.shape != target.shape:
        raise ValueError(
            "Expected argument `preds` and `target` to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if preds.dim() < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), "
            f"got {tuple(preds.shape)}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {tuple(preds.shape)} instead"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) color."""
    unused_category_id = 1 + max([0] + list(things) + list(stuffs))
    return unused_category_id, 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """Map original category ids to dense ids, things first."""
    thing_id_to_continuous_id = {thing_id: idx for idx, thing_id in enumerate(things)}
    stuff_id_to_continuous_id = {stuff_id: idx + len(things) for idx, stuff_id in enumerate(stuffs)}
    cat_id_to_continuous_id = {}
    cat_id_to_continuous_id.update(thing_id_to_continuous_id)
    cat_id_to_continuous_id.update(stuff_id_to_continuous_id)
    return cat_id_to_continuous_id


def _isin(x: Tensor, values: Collection[int]) -> Tensor:
    return torch.isin(x, torch.tensor(sorted(values), dtype=x.dtype, device=x.device))


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Tensor,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> Tensor:
    """Flatten spatial dims, zero stuff instance-ids, map unknown categories to void.

    Returns ``(B, P, 2)`` int64 on the inputs' device.
    """
    out = inputs.to(torch.int64).reshape(inputs.shape[0], -1, 2)
    cat, inst = out[:, :, 0], out[:, :, 1]
    mask_stuffs = _isin(cat, stuffs)
    mask_things = _isin(cat, things)
    inst = torch.where(mask_stuffs, 0, inst)
    unknown = ~(mask_things | mask_stuffs)
    if not allow_unknown_category and bool(unknown.any()):
        raise ValueError(f"Unknown categories found: {torch.stack([cat, inst], -1)[unknown].cpu().numpy()}")
    cat = torch.where(unknown, void_color[0], cat)
    inst = torch.where(unknown, void_color[1], inst)
    return torch.stack([cat, inst], dim=-1)


def _continuous_ids(cat: Tensor, cat_id_to_continuous_id: Dict[int, int]) -> Tensor:
    """The continuous id of each category in ``cat``, -1 for one outside the map."""
    size = max(cat_id_to_continuous_id) + 2
    cont_of = torch.full((size,), -1, dtype=torch.int64)
    for c, cont in cat_id_to_continuous_id.items():
        cont_of[c] = cont
    cont_of = cont_of.to(cat.device)
    inside = (cat >= 0) & (cat < size)
    return torch.where(inside, cont_of[cat.clamp(0, size - 1)], -1)


def _panoptic_quality_update_sample(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-sample stat scores ``(iou_sum, TP, FP, FN)`` per continuous category.

    The pred x target matching is vectorised over the dense ``(Np, Nt)`` intersection
    matrix; segments match when their categories agree and IoU > 0.5 (such matches
    are unique, so no greedy loop is needed).
    """
    stuffs_modified_metric = stuffs_modified_metric or set()
    n_categories = len(cat_id_to_continuous_id)
    device = flatten_preds.device

    # dense relabel: color (cat, inst) -> segment id
    pred_keys = flatten_preds[:, 0] * _ENC + flatten_preds[:, 1]
    target_keys = flatten_target[:, 0] * _ENC + flatten_target[:, 1]
    pred_colors, pred_ids = torch.unique(pred_keys, return_inverse=True)
    target_colors, target_ids = torch.unique(target_keys, return_inverse=True)
    num_p, num_t = pred_colors.numel(), target_colors.numel()
    pred_cat = torch.div(pred_colors, _ENC, rounding_mode="floor")
    target_cat = torch.div(target_colors, _ENC, rounding_mode="floor")

    void_key = void_color[0] * _ENC + void_color[1]
    p_void = pred_colors == void_key  # (Np,) one-hot at most
    t_void = target_colors == void_key

    # areas and intersection matrix: one histogram of the pair ids
    pair_ids = pred_ids * num_t + target_ids
    inter = _bincount(pair_ids, num_p * num_t).reshape(num_p, num_t).to(torch.float64)
    pred_area = inter.sum(dim=1)
    target_area = inter.sum(dim=0)

    # IoU with the void-corrected union
    zero = torch.zeros((), dtype=torch.float64, device=device)
    pred_void_area = torch.where(t_void.any(), inter[:, torch.argmax(t_void.to(torch.int8))], zero)
    void_target_area = torch.where(p_void.any(), inter[torch.argmax(p_void.to(torch.int8)), :], zero)
    union = pred_area[:, None] - pred_void_area[:, None] + target_area[None, :] - void_target_area[None, :] - inter
    positive = union > 0
    iou = torch.where(positive, inter / torch.where(positive, union, torch.ones_like(union)), zero)

    same_cat = pred_cat[:, None] == target_cat[None, :]
    considered = same_cat & (inter > 0) & ~t_void[None, :] & ~p_void[:, None]

    if stuffs_modified_metric:
        modified_stuff_cat = _isin(target_cat, stuffs_modified_metric)
        modified_stuff_pred = _isin(pred_cat, stuffs_modified_metric)
    else:
        modified_stuff_cat = torch.zeros(num_t, dtype=torch.bool, device=device)
        modified_stuff_pred = torch.zeros(num_p, dtype=torch.bool, device=device)
    modified_stuff_pair = modified_stuff_cat[None, :]

    matched = considered & (iou > 0.5) & ~modified_stuff_pair
    modified_matched = considered & (iou > 0) & modified_stuff_pair

    target_cont = _continuous_ids(target_cat, cat_id_to_continuous_id)
    pred_cont = _continuous_ids(pred_cat, cat_id_to_continuous_id)

    pair_cont = target_cont[None, :].expand(matched.shape)
    iou_contrib = torch.where(matched | modified_matched, iou, zero)
    has_cont = pair_cont >= 0
    iou_sum = torch.zeros(n_categories, dtype=torch.float64, device=device).index_add_(
        0, pair_cont.clamp(min=0).reshape(-1), torch.where(has_cont, iou_contrib, zero).reshape(-1)
    )
    true_positives = torch.zeros(n_categories, dtype=torch.int32, device=device).index_add_(
        0, pair_cont.clamp(min=0).reshape(-1), (has_cont & matched).to(torch.int32).reshape(-1)
    )

    # FN: unmatched non-void target segments that are not mostly void in the pred
    target_matched = matched.any(dim=0)
    mostly_void_t = void_target_area > 0.5 * target_area
    fn_mask = ~target_matched & ~t_void & ~mostly_void_t & ~modified_stuff_cat & (target_cont >= 0)
    false_negatives = torch.zeros(n_categories, dtype=torch.int32, device=device).index_add_(
        0, target_cont.clamp(min=0), fn_mask.to(torch.int32)
    )

    # FP: unmatched non-void pred segments that are not mostly void in the target
    pred_matched = matched.any(dim=1)
    mostly_void_p = pred_void_area > 0.5 * pred_area
    fp_mask = ~pred_matched & ~p_void & ~mostly_void_p & ~modified_stuff_pred & (pred_cont >= 0)
    false_positives = torch.zeros(n_categories, dtype=torch.int32, device=device).index_add_(
        0, pred_cont.clamp(min=0), fp_mask.to(torch.int32)
    )

    # modified PQ: TP counts every target segment of a modified-stuff category
    if stuffs_modified_metric:
        seg_mask = modified_stuff_cat & (target_cont >= 0)
        true_positives = true_positives.index_add_(0, target_cont.clamp(min=0), seg_mask.to(torch.int32))

    return iou_sum, true_positives, false_positives, false_negatives


def _panoptic_quality_update(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batch stat scores. Segments never match across samples."""
    n_categories = len(cat_id_to_continuous_id)
    device = flatten_preds.device
    iou_sum = torch.zeros(n_categories, dtype=torch.float64, device=device)
    true_positives = torch.zeros(n_categories, dtype=torch.int32, device=device)
    false_positives = torch.zeros(n_categories, dtype=torch.int32, device=device)
    false_negatives = torch.zeros(n_categories, dtype=torch.int32, device=device)

    for preds_single, target_single in zip(flatten_preds, flatten_target):
        result = _panoptic_quality_update_sample(
            preds_single,
            target_single,
            cat_id_to_continuous_id,
            void_color,
            stuffs_modified_metric=modified_metric_stuffs,
        )
        iou_sum += result[0]
        true_positives += result[1]
        false_positives += result[2]
        false_negatives += result[3]

    return iou_sum, true_positives, false_positives, false_negatives


def _panoptic_quality_compute(
    iou_sum: Tensor,
    true_positives: Tensor,
    false_positives: Tensor,
    false_negatives: Tensor,
) -> Tensor:
    """PQ = IoU-sum / (TP + FP/2 + FN/2), averaged over the seen categories."""
    denominator = (true_positives + 0.5 * false_positives + 0.5 * false_negatives).to(torch.float64)
    seen = denominator > 0
    panoptic_quality = torch.where(
        seen, iou_sum / torch.where(seen, denominator, torch.ones_like(denominator)), torch.zeros_like(denominator)
    )
    value = panoptic_quality.sum() / torch.clamp(seen.sum(), min=1)
    return torch.where(seen.any(), value, torch.full_like(value, float("nan")))


def _prepare_inputs(preds, target, device=None) -> Tuple[Tensor, Tensor]:
    """``preds`` and ``target`` as tensors on one device (``cuda`` for array-likes by default)."""
    preds = to_tensor(preds, device)
    return preds, to_tensor(target, preds.device)
