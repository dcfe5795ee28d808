"""Confusion-matrix counting (counterpart of ``metrics_tpu/ops/confmat.py``).

One masked histogram of ``target * C + preds`` over ``C^2`` bins. The JAX package
adds a one-hot matmul tier for 45 < C <= 512 on the TPU; on the card the histogram
kernel covers that range itself (up to ``C^2 = 2^14``), so there is no second tier.
The valid mask goes to the histogram as bool, so the counts are integers at any N
(the JAX package's float32 mask weights are exact only to 2^24 per bin).

:func:`pair_confusion_counts` counts the contingency tables of many column pairs in
one histogram launch (the nominal ``_matrix`` forms), where the JAX package builds one
confusion matrix per pair.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops.histogram import KERNEL_MAX_BINS
from metrics_tpu_torch.utils.data import _bincount, _bincount_weighted


def confusion_counts(preds: Tensor, target: Tensor, valid: Optional[Tensor], num_classes: int) -> Tensor:
    """(C, C) int64 counts indexed ``[target, pred]``; entries with ``valid`` False drop out.

    Labels are clipped into ``[0, C-1]``, as the JAX package does; masked entries are
    clipped too but carry no weight.
    """
    p = preds.reshape(-1).clamp(0, num_classes - 1).to(torch.int32)
    t = target.reshape(-1).clamp(0, num_classes - 1).to(torch.int32)
    mapping = t * num_classes + p
    if valid is None:  # no mask to read: the kernel's count mode
        bins = _bincount(mapping, num_classes**2)
    else:
        bins = _bincount_weighted(mapping, valid.reshape(-1).to(torch.bool), num_classes**2)
    return bins.reshape(num_classes, num_classes).to(torch.int64)


def pair_confusion_counts(
    columns: Tensor, pairs: Sequence[Tuple[int, int]], cardinalities: Sequence[int], valid: Optional[Tensor] = None
) -> Tensor:
    """Contingency tables of many column pairs, counted together.

    ``columns`` is ``(N, V)`` of dense per-column ids (column ``v`` in
    ``[0, cardinalities[v])``), ``valid`` an optional ``(N, V)`` bool mask: a row
    counts for pair ``(i, j)`` only where both of its entries are valid. Returns an
    ``(P, R, K)`` int64 tensor, ``R = max C_j`` and ``K = max C_i`` over the pairs,
    whose block ``[p, :C_j, :C_i]`` is pair ``p = (i, j)``'s table indexed
    ``[column j's id, column i's id]`` (the ``[target, preds]`` of a confusion matrix
    with column ``i`` as ``preds``); the padding is zero.

    Pair ``p`` owns the bins ``offset_p + b * C_i + a``, ``Σ C_i·C_j`` in all. They are
    cut into windows of at most ``KERNEL_MAX_BINS`` bins (a pair larger than that
    gets several), packed greedily into launches of at most that many bins, so that
    a CUDA batch always takes the histogram kernel's count mode: one launch while
    ``Σ C_i·C_j <= 2^14``. A row outside a window, or not valid, gets id -1 there and
    drops.
    """
    device = columns.device
    n = columns.shape[0]
    sizes = [cardinalities[i] * cardinalities[j] for i, j in pairs]
    rows = max((cardinalities[j] for _, j in pairs), default=0)
    cols = max((cardinalities[i] for i, _ in pairs), default=0)
    out = torch.zeros(len(pairs) * rows * cols, dtype=torch.int64, device=device)
    launches: List[List[Tuple[int, int, int]]] = [[]]
    room = KERNEL_MAX_BINS
    for p, size in enumerate(sizes):
        for lo in range(0, size, KERNEL_MAX_BINS):
            hi = min(size, lo + KERNEL_MAX_BINS)
            if hi - lo > room:
                launches.append([])
                room = KERNEL_MAX_BINS
            launches[-1].append((p, lo, hi))
            room -= hi - lo
    for windows in launches:
        if not windows or n == 0:
            continue
        p_idx, lo, hi = (np.asarray(v, dtype=np.int64) for v in zip(*windows))
        first = np.asarray([pairs[p][0] for p in p_idx])
        second = np.asarray([pairs[p][1] for p in p_idx])
        width = np.asarray([cardinalities[i] for i in first], dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(hi - lo)])
        # each bin's place in the padded (P, R, K) output
        dest = np.concatenate([
            p * rows * cols + np.arange(a, z) // w * cols + np.arange(a, z) % w
            for p, w, a, z in zip(p_idx, width, lo, hi)
        ])
        params = torch.as_tensor(np.stack([first, second, width, lo, hi, base[:-1]]), device=device)
        i_, j_, w_, lo_, hi_, base_ = params
        local = columns[:, j_].long() * w_ + columns[:, i_].long()  # (N, windows)
        keep = (local >= lo_) & (local < hi_)
        if valid is not None:
            keep &= valid[:, i_] & valid[:, j_]
        ids = torch.where(keep, local - lo_ + base_, -1).to(torch.int32).reshape(-1)
        counts = _bincount(ids, int(base[-1]))
        out[torch.as_tensor(dest, device=device)] = counts.to(torch.int64)
    return out.reshape(len(pairs), rows, cols)
