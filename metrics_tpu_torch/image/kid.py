"""Kernel inception distance (counterpart of ``metrics_tpu/image/kid.py``).

``compute`` draws the subsets as the JAX package does, from
``np.random.default_rng(np.random.randint(0, 2**31))``, so a caller that seeds numpy's
global state gets the same subsets in both packages. The polynomial-kernel MMD of a
chunk of subsets is one batched matmul per kernel matrix; a chunk's gathered features
and kernel matrices stay under ``_KID_CHUNK_BYTES``.

Deviation from the JAX package: the kernels and the MMD are computed in float64 (the
value is returned in float32). The MMD is a small difference of large kernel means:
where features are large (as the seeded random InceptionV3's are) the cubic kernel
is orders of magnitude above the MMD, and float32 sums lose most of its digits.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image.fid import _extract
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import dim_zero_cat

_KID_CHUNK_BYTES = 1 << 30


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """Unbiased MMD from the kernel matrices, over a leading batch axis if there is one."""
    m = k_xx.shape[-1]
    kt_xx_sums = k_xx.sum(-1) - torch.diagonal(k_xx, dim1=-2, dim2=-1)
    kt_yy_sums = k_yy.sum(-1) - torch.diagonal(k_yy, dim1=-2, dim2=-1)
    k_xy_sums = k_xy.sum(-2)

    value = (kt_xx_sums.sum(-1) + kt_yy_sums.sum(-1)) / (m * (m - 1))
    return value - 2 * k_xy_sums.sum(-1) / (m**2)


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """``(f1 f2^T gamma + coef)^degree``, batched over a leading axis if there is one."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    with fp32_exact():
        return (torch.matmul(f1, f2.transpose(-2, -1)) * gamma + coef) ** degree


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


def _kid_subset_scores(
    rf: Tensor, ff: Tensor, idx_real: Tensor, idx_fake: Tensor, degree: int, gamma: Optional[float], coef: float
) -> Tensor:
    """The MMD of each subset (one row of ``idx_real``/``idx_fake``), a chunk of subsets at a time."""
    rf, ff = rf.to(torch.float64), ff.to(torch.float64)
    subsets, size = idx_real.shape
    per_subset = (2 * size * rf.shape[1] + 3 * size * size) * rf.element_size()
    chunk = max(1, _KID_CHUNK_BYTES // per_subset)
    return torch.cat([
        poly_mmd(rf[idx_real[i : i + chunk]], ff[idx_fake[i : i + chunk]], degree, gamma, coef)
        for i in range(0, subsets, chunk)
    ])


class KernelInceptionDistance(Metric):
    """KID: polynomial-kernel MMD between real and generated features over random
    subsets; ``compute`` returns the mean and standard deviation over subsets.

    ``feature`` takes a callable extractor (see :class:`FrechetInceptionDistance`) or
    an int tap of the pretrained InceptionV3.
    """

    higher_is_better: bool = False
    is_differentiable: bool = False
    full_state_update: bool = False
    # compute subsamples with host draws, numpy permutations (the JAX class declares it too)
    _host_side_compute = True

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if isinstance(feature, int):
            from metrics_tpu_torch.models.inception import load_inception_feature_extractor

            self.inception, _ = load_inception_feature_extractor(feature, device=self.device)
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor, real: bool) -> None:
        features = _extract(self, imgs)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(KID mean, KID std) over the random subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        rng = np.random.default_rng(np.random.randint(0, 2**31))
        idx_real = np.stack([rng.permutation(n_samples_real)[: self.subset_size] for _ in range(self.subsets)])
        idx_fake = np.stack([rng.permutation(n_samples_fake)[: self.subset_size] for _ in range(self.subsets)])

        kid_scores = _kid_subset_scores(
            real_features,
            fake_features,
            torch.as_tensor(idx_real, device=real_features.device),
            torch.as_tensor(idx_fake, device=fake_features.device),
            self.degree,
            self.gamma,
            self.coef,
        )
        return kid_scores.mean().to(torch.float32), kid_scores.std().to(torch.float32)

    def reset(self) -> None:
        """Reset, keeping the real features when ``reset_real_features`` is False."""
        if self.reset_real_features:
            super().reset()
            return
        real_features = self.real_features
        super().reset()
        self.real_features = real_features
