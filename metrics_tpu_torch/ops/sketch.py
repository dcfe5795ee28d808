"""Hashing and bucketing primitives of the mergeable sketch metrics.

Counterpart of ``metrics_tpu/ops/sketch.py`` (all of it): the murmur3 finalizer and
the seeded canonical hash (:func:`fmix32`, :func:`hash_u32`), HyperLogLog's register
index and rank (:func:`hll_index_rank`) and estimate (:func:`hll_estimate`), the
log-γ buckets of the relative-error quantile sketch (:func:`quantile_gamma`,
:func:`log_bucket_index`, :func:`bucket_midpoints`) and the histogram they count
into (:func:`counts_into_bins`).

u32 arithmetic without ``torch.uint32``: PyTorch's unsigned 32-bit type lacks most
arithmetic, so the hash keeps its u32 values in int64, masked to 32 bits after each
step. Every value stays non-negative, so ``>>`` is a logical shift, and each product
by a 32-bit constant is taken as two products by its 16-bit halves, each below 2^48,
so no product overflows int64. The results are the JAX package's bit for bit.

Count-leading-zeros: ``jax.lax.clz`` has no torch counterpart. :func:`_clz32` takes
it exactly by a five-step binary search of shifts and compares, which runs on any
device and under ``torch.func.vmap``.

:func:`counts_into_bins` takes its callers' 0/1 masks as a bool mask, so on the card
the histogram kernel's mask mode counts them in int32, exactly; above
``KERNEL_MAX_BINS`` (``QuantileSketch(bits=15/16)``) the card takes the histogram's
scatter-add path, the counterpart of the JAX package's scatter fallback.

``log_bucket_index`` computes ``floor((log(mag) - log(min_value)) / log γ)`` in
float32 as the JAX package does; ``torch.log`` and XLA's ``log`` may differ by one
ulp, so a value within an ulp of a bucket edge may land in the next bucket (the JAX
package's own docstring says the same of two compilations of its ``log``).
"""
import math
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops.histogram import bincount_weighted
from metrics_tpu_torch.ops.rank import f32_bits

_U32 = 0xFFFFFFFF


def _mul_u32(h: Tensor, c: int) -> Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit constant ``c``:
    by the constant's 16-bit halves, so every partial product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def fmix32(h: Tensor) -> Tensor:
    """Murmur3 32-bit finalizer, a full-avalanche bijection on u32 values held in
    int64 (the input's low 32 bits are taken)."""
    h = h.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _mix_seed(seed: int) -> int:
    """Host-side fmix32 of a golden-ratio-spread seed, added (not XORed) to the hash
    input by :func:`hash_u32`, so that no seed maps an aligned block of ids onto itself."""
    h = (seed * 0x9E3779B9 + 1) & _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    return h


def hash_u32(values: Tensor, seed: int = 0) -> Tensor:
    """Canonical u32 hash (held in int64) of an int, float or bool tensor, elementwise.

    Floats are taken as float32 (float16 and bfloat16 widen exactly) and hashed by bit
    pattern with -0.0 folded into +0.0; integers and bools as u32 (int32 negatives
    wrap, wider integers keep their low 32 bits). NaN hashes by its float32 pattern.
    """
    if values.is_floating_point():
        bits = f32_bits(values.to(torch.float32)).to(torch.int64) & _U32
        bits = torch.where(bits == 0x80000000, 0, bits)
    else:
        bits = values.to(torch.int64) & _U32
    return fmix32((bits + _mix_seed(int(seed))) & _U32)


def _clz32(w: Tensor) -> Tensor:
    """Leading zeros of nonzero u32 values held in int64 (binary search, exact)."""
    n = torch.zeros_like(w)
    for shift in (16, 8, 4, 2, 1):
        top_clear = (w >> (32 - shift)) == 0
        n = n + torch.where(top_clear, shift, 0)
        w = torch.where(top_clear, (w << shift) & _U32, w)
    return n


def hll_index_rank(h: Tensor, p: int) -> Tuple[Tensor, Tensor]:
    """(register index, rank) of each hash for ``2^p`` HyperLogLog registers.

    The index is the top ``p`` bits (int64); the rank, uint8, is one more than the
    leading zeros of the other ``32 - p``, capped at ``33 - p`` by a sentinel bit.
    """
    if not 4 <= p <= 16:
        raise ValueError(f"HLL precision p must be in [4, 16], got {p}")
    h = h.to(torch.int64) & _U32
    idx = h >> (32 - p)
    w = ((h << p) & _U32) | (1 << (p - 1))
    return idx, (_clz32(w) + 1).to(torch.uint8)


def hll_alpha(m: int) -> float:
    """Bias-correction constant α_m (Flajolet et al. 2007, Fig. 3)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def hll_estimate(registers: Tensor) -> Tensor:
    """Cardinality estimate from the uint8 registers, float32, with linear counting
    below 2.5m while empty registers remain and the 32-bit saturation correction
    above 2^32/30."""
    m = registers.shape[-1]
    reg = registers.to(torch.float32)
    z = torch.sum(torch.exp2(-reg), dim=-1)
    e_raw = torch.tensor(hll_alpha(m) * m * m, dtype=torch.float32) / z
    v = torch.sum((registers == 0).to(torch.float32), dim=-1)
    e_small = float(m) * torch.log(torch.tensor(float(m), dtype=torch.float32) / torch.clamp(v, min=1.0))
    e = torch.where((e_raw <= 2.5 * m) & (v > 0), e_small, e_raw)
    two32 = 4294967296.0
    return torch.where(e > two32 / 30.0, -two32 * torch.log1p(-e / two32), e)


# ----------------------------------------------------- log-γ quantile buckets


def quantile_gamma(relative_error: float) -> float:
    """γ such that a log-γ bucket's midpoint is within ``relative_error`` of every
    value in the bucket: γ = (1+α)/(1-α)."""
    if not 0.0 < relative_error < 1.0:
        raise ValueError(f"relative_error must be in (0, 1), got {relative_error}")
    return (1.0 + relative_error) / (1.0 - relative_error)


def log_bucket_index(mag: Tensor, log_gamma: float, min_value: float, num_buckets: int) -> Tensor:
    """Bucket ``floor(log_γ(mag / min_value))`` as int32, clamped to ``[-1, num_buckets]``.

    -1 is the underflow sentinel (0 < mag < min_value; zeros and NaN map there too),
    ``num_buckets`` the overflow one (+inf included). Clamped in float space, so inf
    never reaches the int cast.
    """
    positive = mag > 0
    safe = torch.where(positive, mag, 1.0)
    log_min = torch.tensor(math.log(min_value), dtype=torch.float32)
    idx_f = torch.floor((torch.log(safe) - log_min) / torch.tensor(log_gamma, dtype=torch.float32))
    idx_f = torch.where(positive, idx_f, -1.0)
    return torch.clamp(idx_f, -1.0, float(num_buckets)).to(torch.int32)


def bucket_midpoints(num_buckets: int, log_gamma: float, min_value: float, device=None) -> Tensor:
    """Per-bucket value estimate ``min_value·γ^i·2γ/(γ+1)`` in float32: the point whose
    worst relative error over ``[min_value·γ^i, min_value·γ^(i+1))`` is α."""
    gamma = math.exp(log_gamma)
    i = torch.arange(num_buckets, dtype=torch.float32, device=device)
    log_min = torch.tensor(math.log(min_value), dtype=torch.float32)
    scale = torch.tensor(2.0 * gamma / (gamma + 1.0), dtype=torch.float32)
    return torch.exp(log_min + i * torch.tensor(log_gamma, dtype=torch.float32)) * scale


def counts_into_bins(idx: Tensor, mask: Tensor, num_bins: int) -> Tensor:
    """int32 counts of the ids whose ``mask`` is set, over ``[0, num_bins)``; other ids
    drop (the callers' sentinels). On the card: the histogram kernel's mask mode, or
    the scatter-add path above its bins."""
    return bincount_weighted(idx, mask.to(torch.bool), num_bins)
