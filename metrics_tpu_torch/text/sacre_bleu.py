"""SacreBLEUScore (counterpart of ``metrics_tpu/text/sacre_bleu.py``)."""
from functools import partial
from typing import Any, Optional, Sequence

from metrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from metrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU with sacrebleu's tokenization.

    Args:
        n_gram: largest n-gram order.
        smooth: add-one smoothing of the orders above 1.
        tokenize: one of ``'none' | '13a' | 'zh' | 'intl' | 'char'``.
        lowercase: case-insensitive scoring.
        weights: per-order weights (uniform by default).
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self._tokenizer = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
