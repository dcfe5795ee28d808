"""BLEUScore (counterpart of ``metrics_tpu/text/bleu.py``)."""
from typing import Any, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn


class BLEUScore(Metric):
    """BLEU of machine-translated text against one or more references.

    Args:
        n_gram: largest n-gram order.
        smooth: add-one smoothing of the orders above 1.
        weights: per-order weights (uniform by default).

    The n-gram counting runs on the host; the counts (int64) live on the metric's
    device.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram

        self.add_state("preds_len", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("target_len", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram, dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram, dtype=torch.int64), dist_reduce_fx="sum")

    _tokenizer = staticmethod(_tokenize_fn)

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        numerator, denominator, preds_len, target_len = _bleu_score_update(
            preds_, target_, self.n_gram, self._tokenizer
        )
        self.numerator = self.numerator + torch.tensor(numerator, dtype=torch.int64, device=self.device)
        self.denominator = self.denominator + torch.tensor(denominator, dtype=torch.int64, device=self.device)
        self.preds_len = self.preds_len + preds_len
        self.target_len = self.target_len + target_len

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )
