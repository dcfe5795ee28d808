"""MatchErrorRate (counterpart of ``metrics_tpu/text/mer.py``)."""
from typing import Any, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update


class MatchErrorRate(Metric):
    """Match error rate, edit errors over max(reference, hypothesis) length (0 = perfect).

    The string work runs on the host; the counts (int64) live on the metric's device.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        errors, total = _mer_update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
