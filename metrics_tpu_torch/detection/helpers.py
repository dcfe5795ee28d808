"""Input validation and device handling of the detection metrics (counterpart of
``metrics_tpu/detection/helpers.py``: ``_is_rle_list`` :10, ``_input_validator`` :17,
``_validate_consolidated`` :78, ``_fix_empty_tensors`` :120).

The checks and their messages are the JAX package's; "Array" means a tensor or a
numpy array. :class:`DetectionInputs` lets a metric take lists of per-image dicts:
``Metric``'s update wrapper moves array-likes to the metric's device one by one, and
here it walks the dicts, leaving COCO RLE lists and anything that is not an array
(which the validators then refuse) as they are.
"""
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

_ARRAY_TYPES = (Tensor, np.ndarray)


def _is_rle_list(value) -> bool:
    """True for a per-image ``masks`` given as a (possibly empty) list of COCO RLE dicts."""
    return isinstance(value, (list, tuple)) and all(
        isinstance(r, dict) and "size" in r and "counts" in r for r in value
    )


class DetectionInputs:
    """Mixin of the detection metrics: ``update`` inputs are (lists of) dicts of arrays."""

    def _check_device(self, value: Any) -> Any:
        if isinstance(value, dict):
            return {k: self._check_device(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)) and all(isinstance(v, dict) for v in value):
            if value and _is_rle_list(value):
                return value
            return [self._check_device(v) for v in value]
        if isinstance(value, _ARRAY_TYPES):
            return super()._check_device(value)
        return value


def _input_validator(preds: Sequence[Dict], targets: Sequence[Dict], iou_type: str = "bbox") -> None:
    """Ensure the correct input format of ``preds`` and ``targets``."""
    if iou_type == "bbox":
        item_val_name = "boxes"
    elif iou_type == "segm":
        item_val_name = "masks"
    else:
        raise Exception(f"IOU type {iou_type} is not supported")

    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    for k in [item_val_name, "scores", "labels"]:
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")

    for k in [item_val_name, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    # masks may also arrive as per-image lists of COCO RLE dicts (decoded host-side by rle.py)
    def _item_ok(value):
        return isinstance(value, _ARRAY_TYPES) or (item_val_name == "masks" and _is_rle_list(value))

    if any(not _item_ok(pred[item_val_name]) for pred in preds):
        raise ValueError(f"Expected all {item_val_name} in `preds` to be of type Array")
    if any(not isinstance(pred["scores"], _ARRAY_TYPES) for pred in preds):
        raise ValueError("Expected all scores in `preds` to be of type Array")
    if any(not isinstance(pred["labels"], _ARRAY_TYPES) for pred in preds):
        raise ValueError("Expected all labels in `preds` to be of type Array")
    if any(not _item_ok(target[item_val_name]) for target in targets):
        raise ValueError(f"Expected all {item_val_name} in `target` to be of type Array")
    if any(not isinstance(target["labels"], _ARRAY_TYPES) for target in targets):
        raise ValueError("Expected all labels in `target` to be of type Array")

    def _n_items(value):
        return len(value) if _is_rle_list(value) else value.shape[0]

    for i, item in enumerate(targets):
        if _n_items(item[item_val_name]) != item["labels"].shape[0]:
            raise ValueError(
                f"Input {item_val_name} and labels of sample {i} in targets have a"
                f" different length (expected {_n_items(item[item_val_name])} labels, got {item['labels'].shape[0]})"
            )
    for i, item in enumerate(preds):
        if not (_n_items(item[item_val_name]) == item["labels"].shape[0] == item["scores"].shape[0]):
            raise ValueError(
                f"Input {item_val_name}, labels and scores of sample {i} in predictions have a"
                f" different length (expected {_n_items(item[item_val_name])} labels and scores,"
                f" got {item['labels'].shape[0]} labels and {item['scores'].shape[0]} scores)"
            )


def _shape(x) -> tuple:
    return tuple(x.shape)


def _validate_consolidated(preds: Dict, target: Dict, iou_type: str = "bbox") -> None:
    """Validate the consolidated input layout.

    ``preds``/``target`` are single dicts of batched padded arrays, the shape a
    detection model with a fixed number of detections per image emits:
    ``preds[boxes|masks] (B, M, 4)`` / ``(B, M, H, W)``, ``scores (B, M)``,
    ``labels (B, M)``; rows with ``labels < 0`` are padding.
    """
    item_val_name = "masks" if iou_type == "segm" else "boxes"
    for name, item, keys in (("preds", preds, (item_val_name, "scores", "labels")),
                             ("target", target, (item_val_name, "labels"))):
        for k in keys:
            if k not in item:
                raise ValueError(f"Expected consolidated `{name}` dict to contain the `{k}` key")
            if not isinstance(item[k], _ARRAY_TYPES):
                raise ValueError(f"Expected consolidated `{name}[{k!r}]` to be an Array")
        main_ndim = 4 if item_val_name == "masks" else 3
        main = item[item_val_name]
        if main.ndim != main_ndim or (item_val_name == "boxes" and main.shape[-1] != 4):
            raise ValueError(
                f"Expected consolidated `{name}[{item_val_name!r}]` to have shape"
                f" {'(B, M, H, W)' if item_val_name == 'masks' else '(B, M, 4)'}, got {_shape(main)}"
            )
        if _shape(item["labels"]) != _shape(main)[:2]:
            raise ValueError(
                f"Expected consolidated `{name}['labels']` shape {_shape(main)[:2]},"
                f" got {_shape(item['labels'])}"
            )
    if _shape(preds["scores"]) != _shape(preds["labels"]):
        raise ValueError(
            f"Expected consolidated `preds['scores']` shape {_shape(preds['labels'])},"
            f" got {_shape(preds['scores'])}"
        )
    if preds[item_val_name].shape[0] != target[item_val_name].shape[0]:
        raise ValueError(
            f"Expected consolidated `preds` and `target` to cover the same images, got"
            f" batch {preds[item_val_name].shape[0]} vs {target[item_val_name].shape[0]}"
        )


def _to_host(items: Sequence[Tensor]) -> List[np.ndarray]:
    """Each tensor as a numpy array, with one device-to-host copy per dtype."""
    out: List[Optional[np.ndarray]] = [None] * len(items)
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(items):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        host = torch.cat([items[i].reshape(-1) for i in idx]).cpu().numpy()
        offsets = np.cumsum([0] + [items[i].numel() for i in idx])
        for j, i in enumerate(idx):
            out[i] = host[offsets[j]:offsets[j + 1]].reshape(tuple(items[i].shape))
    return out


def _fix_empty_tensors(boxes: Tensor) -> Tensor:
    """Give empty box tensors the canonical ``(0, 4)`` shape, as float32.

    A copy even when already float32: the stored state must not alias the caller's
    buffer (in-place reuse between updates would corrupt it).
    """
    boxes = boxes.to(torch.float32, copy=True)
    if boxes.numel() == 0:
        return boxes.reshape(0, 4)
    return boxes
