"""Spectral distortion index metric (counterpart of ``metrics_tpu/image/d_lambda.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from metrics_tpu_torch.utils.data import dim_zero_cat


class SpectralDistortionIndex(Metric):
    """D_lambda for pan-sharpening quality, over the concatenated batches."""

    higher_is_better: bool = False
    is_differentiable: bool = True
    full_state_update: bool = False

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        if preds.shape != target.shape:
            raise ValueError(f"Expected same shapes, got {tuple(preds.shape)} and {tuple(target.shape)}")
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return spectral_distortion_index(preds, target, self.p, self.reduction)
