"""Inception score (counterpart of ``metrics_tpu/image/inception.py``).

``compute`` permutes the features with ``np.random.permutation``, as the JAX package
does, so a caller that seeds numpy's global state gets the same splits in both.

Deviation from the JAX package: the probabilities are computed in float64 (the value is
returned in float32). In float32 a class whose softmax underflows to 0 in every image
of a split (logits spread by more than ~100) gives ``0 * inf`` and a NaN score.
"""
from typing import Any, Callable, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.image.fid import _extract
from metrics_tpu_torch.utils.data import dim_zero_cat


def _is_scores(features: Tensor, perm: Tensor, splits: int) -> Tuple[Tensor, Tensor]:
    """Mean and standard deviation over ``splits`` of the mean KL(p(y|x) || p(y))."""
    features = features[perm]
    prob = torch.softmax(features, dim=1)
    log_prob = torch.log_softmax(features, dim=1)
    kl_ = []
    for p, log_p in zip(torch.tensor_split(prob, splits), torch.tensor_split(log_prob, splits)):
        mean_prob = p.mean(dim=0, keepdim=True)
        kl = p * (log_p - torch.log(mean_prob))
        kl_.append(kl.sum(dim=1).mean())
    kl = torch.stack(kl_)
    return kl.mean(), kl.std()


class InceptionScore(Metric):
    """IS over class logits: the mean and standard deviation over ``splits`` of
    E_x KL(p(y|x) || p(y)), as the JAX package computes it.

    ``feature`` is a callable producing class logits per image, or ``"logits_unbiased"``
    or an int tap of the pretrained InceptionV3 (a local weights file is needed).
    """

    higher_is_better: bool = True
    is_differentiable: bool = False
    full_state_update: bool = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if isinstance(feature, (str, int)):
            from metrics_tpu_torch.models.inception import load_inception_feature_extractor

            self.inception, _ = load_inception_feature_extractor(feature, device=self.device)
        elif callable(feature):
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Expected argument `splits` to be an integer larger than 0")
        self.splits = splits
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor) -> None:
        self.features.append(_extract(self, imgs))

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(IS mean, IS std) over the splits of a random permutation of the features."""
        features = dim_zero_cat(self.features)
        idx = np.random.permutation(features.shape[0])
        mean, std = _is_scores(features.to(torch.float64), torch.as_tensor(idx, device=features.device), self.splits)
        return mean.to(torch.float32), std.to(torch.float32)
