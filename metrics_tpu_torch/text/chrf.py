"""CHRFScore (counterpart of ``metrics_tpu/text/chrf.py``): the six count vectors as
six int64 vector states, as the JAX package keeps them in float32."""
from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update
from metrics_tpu_torch.utils.data import dim_zero_cat

_STATES = ("preds_char", "preds_word", "target_char", "target_word", "matching_char", "matching_word")


class CHRFScore(Metric):
    """chrF (``n_word_order=0``) or chrF++ (the default) score.

    Args:
        n_char_order: character n-gram order (6 in chrF and chrF++).
        n_word_order: word n-gram order (2 in chrF++, 0 in chrF).
        beta: recall weight of the F-score.
        lowercase: case-insensitive scoring.
        whitespace: keep whitespace in the character n-grams.
        return_sentence_level_score: ``compute`` also returns the sentence scores.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        for name in _STATES:
            order = n_char_order if name.endswith("char") else n_word_order
            self.add_state(f"total_{name}_n_grams", torch.zeros(order, dtype=torch.int64), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        *counts, sentence_scores = _chrf_score_update(
            preds,
            target,
            self.n_char_order,
            self.n_word_order,
            self.beta,
            self.lowercase,
            self.whitespace,
            self.return_sentence_level_score,
        )
        for name, count in zip(_STATES, counts):
            attr = f"total_{name}_n_grams"
            setattr(self, attr, getattr(self, attr) + torch.from_numpy(count).to(self.device))
        if self.return_sentence_level_score:
            self.sentence_chrf_score.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_score_compute(
            *(getattr(self, f"total_{name}_n_grams") for name in _STATES), self.n_order, self.beta
        )
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score
