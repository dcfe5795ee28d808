"""Universal image quality index metric (counterpart of ``metrics_tpu/image/uqi.py``)."""
from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index


class UniversalImageQualityIndex(Metric):
    """UQI over batches: the pixel-level sum and count for ``sum`` and
    ``elementwise_mean``, the per-batch maps for ``none``, as in the JAX package."""

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("score_maps", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        score_map = universal_image_quality_index(preds, target, self.kernel_size, self.sigma, reduction="none")
        if self.reduction in ("none", None):
            self.score_maps.append(score_map)
        else:
            self.score_sum = self.score_sum + score_map.sum()
            self.total = self.total + score_map.numel()

    def compute(self) -> Tensor:
        if self.reduction in ("none", None):
            return torch.cat(self.score_maps, dim=0)
        if self.reduction == "sum":
            return self.score_sum
        return self.score_sum / self.total
