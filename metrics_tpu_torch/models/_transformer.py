"""Shared transformer pieces of the BERT and CLIP ports (counterpart of
``metrics_tpu/models/_transformer.py``).

The math is the JAX package's, in float32: layer norm with the biased variance,
``x @ W.T + b`` linears (``nn.Linear`` layout), and attention as ``q @ k.T / sqrt(dh)``
plus an additive bias, ``softmax`` and ``@ v``. No fused attention kernel is called:
the JAX package computes the plain product, and so does the port.
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.utils.data import _next_pow2

# additive attention bias for masked positions; matches HF's mask magnitude
NEG_BIAS = -1e9


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def linear(x: Tensor, layer: nn.Linear) -> Tensor:
    return F.linear(x, layer.weight, layer.bias)


def multi_head_attention(
    x: Tensor,
    q: nn.Linear,
    k: nn.Linear,
    v: nn.Linear,
    out: nn.Linear,
    mask_bias: Optional[Tensor],
    num_heads: int,
) -> Tensor:
    """Scaled-dot-product attention; ``mask_bias`` broadcasts to (B, H, Q, K)."""
    b, s, d = x.shape
    dh = d // num_heads

    def heads(t: Tensor) -> Tensor:
        return t.reshape(b, s, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(linear(x, q)), heads(linear(x, k)), heads(linear(x, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs, vh).transpose(1, 2).reshape(b, s, d)
    return linear(ctx, out)


def infer_num_heads(width: int) -> int:
    """Standard 64-dim attention heads (BERT family and CLIP towers alike)."""
    if width % 64 == 0:
        return width // 64
    raise ValueError(f"Cannot infer head count for width {width}; pass num_heads explicitly")


def pad_token_batch(
    ids: np.ndarray, mask: np.ndarray, pad_id: int, floor: int = 8, cap: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the sequence axis to the next power of two, as the JAX package does.

    The encoders then return the JAX package's shapes. ``cap`` bounds the bucket (a
    model's position table) so that padding never indexes past it. Padded positions
    carry ``mask=0``, so the attended outputs are unchanged.
    """
    s = ids.shape[1]
    m = max(_next_pow2(int(s)), floor)
    if cap is not None:
        m = min(m, max(cap, s))
    if m == s:
        return ids, mask
    pad = ((0, 0), (0, m - s))
    return np.pad(ids, pad, constant_values=pad_id), np.pad(mask, pad, constant_values=0)
