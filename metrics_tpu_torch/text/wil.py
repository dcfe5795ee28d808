"""WordInfoLost (counterpart of ``metrics_tpu/text/wil.py``)."""
from typing import Any, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update


class WordInfoLost(Metric):
    """Word information lost (0 = perfect).

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
        self.add_state("hits", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("target_total", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        hits, target_total, preds_total = _wil_update(preds, target)
        self.hits = self.hits + hits
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        return _wil_compute(self.hits, self.target_total, self.preds_total)
