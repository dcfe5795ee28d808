"""ExtendedEditDistance (counterpart of ``metrics_tpu/text/eed.py``)."""
from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.eed import _eed_compute, _eed_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """Extended edit distance (lower is better; each sentence's score capped at 1).

    Args:
        language: ``"en"`` or ``"ja"`` preprocessing.
        return_sentence_level_score: ``compute`` also returns the sentence scores.
        alpha: long-jump penalty.
        rho: coverage (re-visit) penalty.
        deletion: deletion cost.
        insertion: insertion and substitution cost.

    The state is the float32 list of sentence scores; ``compute`` averages them on
    the host, as the JAX package does.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        self.sentence_eed.append(torch.tensor(scores, dtype=torch.float32, device=self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        # a list locally, one tensor after a sync
        state = self.sentence_eed
        if isinstance(state, list) and not state:
            all_scores = torch.zeros(0, device=self.device)
        else:
            all_scores = dim_zero_cat(state)
        average = _eed_compute(all_scores.tolist(), self.device)
        if self.return_sentence_level_score:
            return average, all_scores
        return average
