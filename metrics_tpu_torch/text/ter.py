"""TranslationEditRate (counterpart of ``metrics_tpu/text/ter.py``)."""
from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class TranslationEditRate(Metric):
    """Translation edit rate (lower is better, 0 = perfect).

    Args:
        normalize: apply Tercom's general tokenization.
        no_punctuation: remove punctuation before scoring.
        lowercase: case-insensitive scoring.
        asian_support: handle CJK characters.
        return_sentence_level_score: ``compute`` also returns the sentence scores.

    The edit count is an int64 state, the summed average reference length float32.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
        if not isinstance(no_punctuation, bool):
            raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
        if not isinstance(lowercase, bool):
            raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
        if not isinstance(asian_support, bool):
            raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("total_tgt_len", torch.tensor(0.0), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        sentence_scores = [] if self.return_sentence_level_score else None
        num_edits, tgt_length, sentence_scores = _ter_update(preds, target, self.tokenizer, sentence_scores)
        self.total_num_edits = self.total_num_edits + num_edits
        self.total_tgt_len = self.total_tgt_len + torch.tensor(tgt_length, dtype=torch.float32, device=self.device)
        if self.return_sentence_level_score:
            self.sentence_ter.append(torch.tensor(sentence_scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _ter_compute(self.total_num_edits, self.total_tgt_len)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_ter)
        return score
