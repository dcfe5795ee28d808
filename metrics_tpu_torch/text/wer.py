"""WordErrorRate (counterpart of ``metrics_tpu/text/wer.py``)."""
from typing import Any, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update


class WordErrorRate(Metric):
    """Word error rate for automatic speech recognition (0 = perfect).

    The string work runs on the host; the counts (int64) live on the metric's device.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        errors, total = _wer_update(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _wer_compute(self.errors, self.total)
