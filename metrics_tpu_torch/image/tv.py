"""Total variation metric (counterpart of ``metrics_tpu/image/tv.py``)."""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class TotalVariation(Metric):
    """Total variation of image batches: a running sum, or the per-image list for ``none``."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction

        if self.reduction is None or self.reduction == "none":
            self.add_state("score_list", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_elements", default=torch.tensor(0), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, num_elements = _total_variation_update(img.to(torch.float32))
        if self.reduction is None or self.reduction == "none":
            self.score_list.append(score)
        else:
            self.score = self.score + score.sum()
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score_list)
        return _total_variation_compute(self.score, self.num_elements, self.reduction)
