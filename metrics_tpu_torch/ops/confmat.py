"""Confusion-matrix counting (counterpart of ``metrics_tpu/ops/confmat.py``).

One masked histogram of ``target * C + preds`` over ``C^2`` bins. The JAX package
adds a one-hot matmul tier for 45 < C <= 512 on the TPU; on the card the histogram
kernel covers that range itself (up to ``C^2 = 2^14``), so there is no second tier.
The valid mask goes to the histogram as bool, so the counts are integers at any N
(the JAX package's float32 mask weights are exact only to 2^24 per bin).
"""
from typing import Optional

import torch
from torch import Tensor

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
