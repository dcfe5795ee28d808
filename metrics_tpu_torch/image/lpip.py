"""LearnedPerceptualImagePatchSimilarity (counterpart of ``metrics_tpu/image/lpip.py``):
a float32 sum of the per-sample distances and an int64 count (the JAX package's is
float32)."""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.lpips import _lpips_invalid_message, _lpips_valid_img
from metrics_tpu_torch.models.lpips import LPIPS_CHANNELS, load_lpips


class LearnedPerceptualImagePatchSimilarity(Metric):
    """Running LPIPS perceptual distance (lower = more similar).

    Args:
        net_type: ``"vgg"`` | ``"alex"`` | ``"squeeze"`` backbone.
        reduction: ``"mean"`` or ``"sum"`` over all seen samples.
        normalize: inputs are in [0, 1] instead of [-1, 1].
        backbone_weights / linear_weights: local weight files (see
            :mod:`metrics_tpu_torch.models.lpips`; required, nothing is downloaded).
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        backbone_weights: Optional[str] = None,
        linear_weights: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if net_type not in LPIPS_CHANNELS:
            raise ValueError(f"Argument `net_type` must be one of {tuple(LPIPS_CHANNELS)}, but got {net_type}")
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of ('mean', 'sum'), but got {reduction}")
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be an bool but got {normalize}")
        self.net_type = net_type
        self.reduction = reduction
        self.normalize = normalize
        self.backbone_weights = backbone_weights
        self.linear_weights = linear_weights
        self._network()  # raises now when a weights file is missing

        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")

    def _network(self):
        # the cached network of this device, held outside the module tree: moving the
        # metric picks (or loads) the network of its new device
        return load_lpips(self.net_type, self.backbone_weights, self.linear_weights, self.device)

    def update(self, img1: Tensor, img2: Tensor) -> None:
        if not (_lpips_valid_img(img1, self.normalize) and _lpips_valid_img(img2, self.normalize)):
            raise ValueError(_lpips_invalid_message(img1, img2, self.normalize))
        loss = self._network()(img1, img2, self.normalize)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + img1.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
