"""TheilsU (counterpart of ``metrics_tpu/nominal/theils_u.py``)."""
from typing import Any, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.nominal.theils_u import _theils_u_compute, _theils_u_update
from metrics_tpu_torch.functional.nominal.utils import _nominal_input_validation


class TheilsU(Metric):
    """Theil's U (uncertainty coefficient) between two categorical series.

    The ``(num_classes, num_classes)`` table ``confmat`` is int64 (float32 in the JAX
    package): exact past 2^24 a bin.
    """

    full_state_update: bool = False
    # compute forms the table's statistics in float64, as the JAX class does on the host in
    # numpy (which declares it too); tmlint and tmsan treat compute as host code, update stays traced
    _host_side_compute = True
    is_differentiable: bool = False
    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[Union[int, float]] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError("Argument `num_classes` is expected to be a positive integer")
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the contingency table."""
        self.confmat = self.confmat + _theils_u_update(
            preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value
        )

    def compute(self) -> Tensor:
        """Theil's U from the accumulated table."""
        return _theils_u_compute(self.confmat)
