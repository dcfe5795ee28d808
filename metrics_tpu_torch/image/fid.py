"""Frechet inception distance (counterpart of ``metrics_tpu/image/fid.py``).

Each image set keeps Chan/Welford centered moments ``(mean, m2, n)``, not raw sums:
every stored quantity is mean-free, so float32 states stay accurate at any ratio of
feature mean to spread. The states have ``dist_reduce_fx=None``: a sync stacks every
process's triple, and ``compute`` folds the stack with the same parallel-variance
merge. ``compute`` factorises in float64 on the states' device
(:func:`~metrics_tpu_torch.functional.image.fid_math._compute_fid`, ``eigh``).

``feature`` is a callable ``(N, C, H, W) -> (N, D)`` (for example a
:class:`~metrics_tpu_torch.models.inception.FeatureExtractorInceptionV3`), or an int
tap of the pretrained InceptionV3, whose weights must be in the local file that
``METRICS_TPU_INCEPTION_WEIGHTS`` names.
"""
from typing import Any, Callable, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.fid_math import _compute_fid
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.compute import fp32_exact


def _chan_merge(
    mean_a: Tensor, m2_a: Tensor, n_a: Tensor, mean_b: Tensor, m2_b: Tensor, n_b: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Parallel-variance merge of two (mean, M2, n) centered-moment triples."""
    tot = n_a + n_b
    safe_tot = torch.clamp(tot, min=1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / safe_tot)
    m2 = m2_a + m2_b + torch.outer(delta, delta) * (n_a * n_b / safe_tot)
    return mean, m2, tot


def _fold_stacked(mean: Tensor, m2: Tensor, n: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Merge per-process stacked triples (a leading process axis) after a sync."""
    if mean.ndim == 2:
        fm, fm2, fn = mean[0], m2[0], n[0]
        for i in range(1, mean.shape[0]):
            fm, fm2, fn = _chan_merge(fm, fm2, fn, mean[i], m2[i], n[i])
        return fm, fm2, fn
    return mean, m2, n


def _extract(metric: Metric, imgs: Tensor) -> Tensor:
    """``metric.inception``'s features of ``imgs`` (scaled to uint8 first under ``normalize``)."""
    imgs = (imgs * 255).to(torch.uint8) if metric.normalize else imgs
    features = metric.inception(imgs)
    if not isinstance(features, Tensor):  # a user extractor's host array
        features = torch.as_tensor(features, device=metric.device)
    return features


class FrechetInceptionDistance(Metric):
    """FID between the features of real and generated images."""

    higher_is_better: bool = False
    is_differentiable: bool = False
    full_state_update: bool = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: int = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if isinstance(feature, int):
            from metrics_tpu_torch.models.inception import load_inception_feature_extractor

            self.inception, num_features = load_inception_feature_extractor(feature, device=self.device)
        elif callable(feature):
            # num_features may be None: the states are then sized at the first update
            self.inception = feature
        else:
            raise TypeError("Got unknown input to argument `feature`")

        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self._states_ready = False
        if num_features is not None:
            self._init_states(num_features)

    def _init_states(self, num_features: int) -> None:
        mx_nb_feets = (num_features, num_features)
        self.add_state("real_mean", torch.zeros(num_features), dist_reduce_fx=None)
        self.add_state("real_m2", torch.zeros(mx_nb_feets), dist_reduce_fx=None)
        self.add_state("real_features_num_samples", torch.tensor(0.0), dist_reduce_fx=None)
        self.add_state("fake_mean", torch.zeros(num_features), dist_reduce_fx=None)
        self.add_state("fake_m2", torch.zeros(mx_nb_feets), dist_reduce_fx=None)
        self.add_state("fake_features_num_samples", torch.tensor(0.0), dist_reduce_fx=None)
        self._states_ready = True

    def _init_states_for_load(self, state: dict) -> None:
        """Size lazily sized states from an incoming state dict (``load_jax_state``)."""
        if not self._states_ready and "real_mean" in state:
            self._init_states(int(state["real_mean"].shape[-1]))

    def update(self, imgs: Tensor, real: bool) -> None:
        """Extract features and merge their centered batch moments into the set's triple."""
        features = _extract(self, imgs)
        if features.ndim == 1:
            features = features[None, :]
        if not self._states_ready:
            self._init_states(features.shape[1])

        features = features.to(self.real_mean.dtype)
        nb = torch.full((), float(features.shape[0]), dtype=features.dtype, device=features.device)
        b_mean = features.mean(0)
        centered = features - b_mean
        with fp32_exact():
            b_m2 = centered.T @ centered
        if real:
            self.real_mean, self.real_m2, self.real_features_num_samples = _chan_merge(
                self.real_mean, self.real_m2, self.real_features_num_samples, b_mean, b_m2, nb
            )
        else:
            self.fake_mean, self.fake_m2, self.fake_features_num_samples = _chan_merge(
                self.fake_mean, self.fake_m2, self.fake_features_num_samples, b_mean, b_m2, nb
            )

    def compute(self) -> Tensor:
        """FID from the folded moments, factorised in float64 on the states' device."""
        if not self._states_ready:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        rm, rm2, rn = _fold_stacked(self.real_mean, self.real_m2, self.real_features_num_samples)
        fm, fm2, fn = _fold_stacked(self.fake_mean, self.fake_m2, self.fake_features_num_samples)
        if _is_concrete(rn, fn) and (float(rn) < 2 or float(fn) < 2):  # skipped in a traced step, as under jit
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        s1 = rm2.to(torch.float64) / (rn.to(torch.float64) - 1)
        s2 = fm2.to(torch.float64) / (fn.to(torch.float64) - 1)
        fid = _compute_fid(rm.to(torch.float64), s1, fm.to(torch.float64), s2, method="eigh")
        return fid.to(torch.float32)

    def reset(self) -> None:
        """Reset, keeping the real set's moments when ``reset_real_features`` is False."""
        if not self._states_ready or self.reset_real_features:
            super().reset()
            return
        real = self.real_mean, self.real_m2, self.real_features_num_samples
        super().reset()
        self.real_mean, self.real_m2, self.real_features_num_samples = real
