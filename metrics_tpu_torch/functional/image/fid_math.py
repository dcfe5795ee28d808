"""Frechet distance math (counterpart of ``metrics_tpu/functional/image/fid_math.py``).

``tr(sqrtm(S1 S2))`` comes from the symmetrised form ``tr(sqrtm(sqrtm(S1) S2 sqrtm(S1)))``
through two Hermitian eigendecompositions (``torch.linalg.eigh``, cuSOLVER on the card),
or from a coupled Newton-Schulz iteration of matmuls only. ``method="auto"`` takes
``eigh``, as the JAX package does on every backend but the TPU.
``FrechetInceptionDistance.compute`` runs ``eigh`` in float64 on the moments' device.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import fp32_exact


def _sqrtm_trace_newton_schulz(a: Tensor, iters: int = 25) -> Tensor:
    """trace(sqrtm(a)) for a matrix with nonnegative real spectrum (e.g. S1 @ S2).

    Coupled Newton-Schulz: with ``y0 = a/||a||``, iterate ``t = (3I - z y)/2;
    y <- y t; z <- t z`` so that y -> sqrtm(y0). Each step costs 3 matmuls plus one
    for the residual ``||y y - y0||`` that selects the best iterate (the iteration
    diverges in float32 once rounding dominates; a NaN residual never wins).
    """
    with fp32_exact():
        norm = torch.linalg.norm(a)
        scale = torch.where(norm > 0, norm, torch.ones_like(norm))
        y0 = a / scale
        eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        y, z = y0, eye
        best_tr = torch.trace(y0)
        best_err = torch.linalg.norm(y0 @ y0 - y0)
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
            err = torch.linalg.norm(y @ y - y0)
            better = err < best_err
            best_tr = torch.where(better, torch.trace(y), best_tr)
            best_err = torch.where(better, err, best_err)
        return best_tr * torch.sqrt(scale)


def _sqrtm_trace_eigh(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """tr(sqrtm(S1 S2)) through the symmetrised form and two eigendecompositions."""
    with fp32_exact():
        vals, vecs = torch.linalg.eigh(sigma1)
        vals = torch.clamp(vals, min=0.0)
        s1_half = (vecs * torch.sqrt(vals)) @ vecs.T
        inner = s1_half @ sigma2 @ s1_half
        return torch.sqrt(torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)).sum()


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor, method: str = "auto") -> Tensor:
    """Frechet distance between two multivariate normals.

    ``method``: ``"eigh"`` (symmetrised eigendecomposition), ``"newton_schulz"``
    (matmuls only) or ``"auto"`` (``eigh``).
    """
    if method == "auto":
        method = "eigh"
    diff = mu1 - mu2
    if method == "newton_schulz":
        with fp32_exact():
            tr_covmean = _sqrtm_trace_newton_schulz(sigma1 @ sigma2)
    elif method == "eigh":
        tr_covmean = _sqrtm_trace_eigh(sigma1, sigma2)
    else:
        raise ValueError(f"Unknown FID sqrtm method: {method}")
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean
