"""SpearmanCorrCoef (counterpart of ``metrics_tpu/regression/spearman.py``)."""
from typing import Any

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation: ``cat`` states (``cat_capacity`` makes them
    ``CatBuffer``s of ``(num_outputs,)`` rows), ranked at ``compute``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        item = () if num_outputs == 1 else (num_outputs,)
        self.add_state("preds", default=[], dist_reduce_fx="cat", cat_item_shape=item)
        self.add_state("target", default=[], dist_reduce_fx="cat", cat_item_shape=item)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _spearman_corrcoef_update(preds, target, self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
