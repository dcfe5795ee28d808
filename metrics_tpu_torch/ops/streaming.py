"""Compare-and-count reductions of the micro-average path.

Counterpart of ``metrics_tpu/ops/streaming.py``, which shapes these reductions for
XLA on the TPU and has no Pallas kernel. Here they are plain PyTorch; a fused
argmax-compare-count kernel is a candidate once the card's profile asks for it.
"""
from typing import Optional

import torch
from torch import Tensor


def eq_count(preds: Tensor, target: Tensor) -> Tensor:
    """``sum(preds == target)`` as an int64 scalar; both inputs 1-D and of equal length."""
    return torch.sum(preds == target, dtype=torch.int64)


def argmax_correct_count(probs: Tensor, target: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """``sum(argmax(probs, -1) == target)`` over rows where ``valid`` holds, as int64.

    ``torch.argmax`` matches ``jnp.argmax``: the first index wins a tie and NaN is
    maximal. ``probs`` is ``(M, C)`` float, ``target`` ``(M,)`` int.
    """
    win = torch.argmax(probs, dim=1) == target
    if valid is not None:
        win = win & valid
    return torch.sum(win, dtype=torch.int64)
