"""SQuAD (counterpart of ``metrics_tpu/text/squad.py``)."""
from typing import Any, Dict, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.squad import _squad_compute, _squad_input_check, _squad_update


class SQuAD(Metric):
    """SQuAD v1 exact match and F1, both in percent.

    The F1 sum is a float32 state, the exact-match and question counts int64 ones.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(
        self,
        preds: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
        target: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
    ) -> None:
        preds_dict, qas = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, qas)
        self.f1_score = self.f1_score + torch.tensor(f1, dtype=torch.float32, device=self.device)
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
