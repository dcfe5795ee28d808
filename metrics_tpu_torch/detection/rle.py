"""COCO run-length-encoded (RLE) mask codec, host-side numpy (the port's own copy of
``metrics_tpu/detection/rle.py``, which imports no JAX).

Users with real COCO annotations hold RLE dicts ``{"size": [h, w], "counts": ...}``.
This module implements the COCO RLE format from its public specification, so that
:class:`~metrics_tpu_torch.detection.MeanAveragePrecision` ingests those dicts with
no pycocotools dependency: decode produces the dense binary mask whose IoU is a
matmul (RLE is a host-memory compaction, not a semantic need — the matching math is
identical either way).

Format notes (COCO spec):
- masks are laid out **column-major** (Fortran order) over an ``(h, w)`` grid;
- ``counts`` is the sequence of run lengths, alternating background/foreground and
  always starting with background (a leading 0 encodes a mask that starts with
  foreground);
- ``counts`` may be an uncompressed list of ints, or a compressed ASCII string:
  each value is split into 6-bit chunks (5 payload bits + 1 continuation bit)
  offset by char 48, and every count after the third is delta-coded against the
  count two positions back.
"""
from typing import Any, Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, Any]


def _counts_from_string(s: Union[str, bytes]) -> List[int]:
    """Decode the compressed COCO counts string (6-bit LEB128 with 2-back deltas)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)  # sign-extend the final chunk
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _counts_to_string(counts: Sequence[int]) -> bytes:
    """Encode run lengths into the compressed COCO counts string."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)


def rle_decode(rle: RLE) -> np.ndarray:
    """Decode one COCO RLE dict into a dense ``(h, w)`` bool mask."""
    if not isinstance(rle, dict) or "size" not in rle or "counts" not in rle:
        raise ValueError(
            "Expected an RLE dict with `size` and `counts` keys, got"
            f" {type(rle).__name__}: {rle!r:.80}"
        )
    h, w = (int(x) for x in rle["size"])
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_from_string(counts)
    counts = np.asarray(counts, np.int64)
    if counts.sum() != h * w:
        raise ValueError(
            f"RLE counts sum to {int(counts.sum())} but `size` {rle['size']} implies {h * w} pixels"
        )
    # runs alternate background/foreground starting with background
    values = np.zeros(len(counts), np.uint8)
    values[1::2] = 1
    flat = np.repeat(values, counts)
    return flat.reshape(w, h).T.astype(bool)  # column-major layout


def rle_encode(mask: np.ndarray, compress: bool = False) -> RLE:
    """Encode a dense ``(h, w)`` binary mask as a COCO RLE dict.

    ``compress=True`` produces the compressed ``counts`` string form; the default
    keeps the uncompressed list of ints.
    """
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"Expected a 2-D (h, w) mask, got shape {mask.shape}")
    h, w = mask.shape
    flat = mask.T.reshape(-1).astype(np.uint8)  # column-major
    if flat.size == 0:
        counts: List[int] = []
    else:
        change = np.nonzero(np.diff(flat))[0] + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        counts = np.diff(bounds).tolist()
        if flat[0] == 1:  # runs must start with background
            counts = [0, *counts]
    rle: RLE = {"size": [h, w], "counts": _counts_to_string(counts) if compress else counts}
    return rle


def masks_from_rle(masks: Sequence[RLE]) -> np.ndarray:
    """Decode a per-image list of RLE dicts into one dense ``(n, h, w)`` bool array."""
    if len(masks) == 0:
        return np.zeros((0, 1, 1), bool)
    decoded = [rle_decode(r) for r in masks]
    shapes = {d.shape for d in decoded}
    if len(shapes) > 1:
        raise ValueError(f"All RLE masks of one image must share a size, got {sorted(shapes)}")
    return np.stack(decoded)
