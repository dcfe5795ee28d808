"""Perplexity (counterpart of ``metrics_tpu/text/perplexity.py``).

On the device: ``update`` reads nothing on the host, so the pure tier
(``init_state``/``local_update``/``compute_from``) runs it inside a captured step,
and ``MetricCollection(fused=True)`` replays it as one CUDA graph.
"""
from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update


class Perplexity(Metric):
    """Perplexity of a language model: ``exp(mean NLL)`` over the tokens not ignored.

    Args:
        ignore_index: a target id that does not count.

    The NLL sum is a float32 state, the token count an int64 one.
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("total_log_probs", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("count", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index, self.validate_args)
        self.total_log_probs = self.total_log_probs + total_log_probs
        self.count = self.count + count

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)
