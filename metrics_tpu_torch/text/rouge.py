"""ROUGEScore (counterpart of ``metrics_tpu/text/rouge.py``)."""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_compute,
    _rouge_score_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE


class ROUGEScore(Metric):
    """ROUGE scores for automatic summarization.

    Args:
        use_stemmer: Porter-stem the tokens longer than 3 characters (needs nltk).
        normalizer: a text normaliser.
        tokenizer: a tokenizer.
        accumulate: several references: ``"best"`` or ``"avg"``.
        rouge_keys: any of ``rouge1``..``rouge9``, ``rougeL``, ``rougeLsum``.

    The states are the per-sample scores, one list per key and statistic
    (``dist_reduce_fx=None``), in the JAX package's layout: one 0-d float32 entry a
    sample, so that a checkpoint restores into either package. ``compute`` joins each
    list once and averages on the host.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    _host_side_update = True

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer and not _NLTK_AVAILABLE:
            raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(
                    f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}"
                )
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.stemmer = None
        if use_stemmer:
            import nltk

            self.stemmer = nltk.stem.porter.PorterStemmer()
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys:
            for score in ["fmeasure", "precision", "recall"]:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx=None)

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        output = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            self.accumulate,
            self.stemmer,
            self.normalizer,
            self.tokenizer,
        )
        # the JAX package's layout, one 0-d float32 entry a sentence (so that a
        # checkpoint crosses): one host-to-device copy a statistic, split into views
        for rouge_key, metrics in output.items():
            for stat in ["fmeasure", "precision", "recall"]:
                values = torch.tensor([m[stat] for m in metrics], dtype=torch.float32, device=self.device)
                getattr(self, f"rouge{rouge_key}_{stat}").extend(values.unbind(0))

    def compute(self) -> Dict[str, Tensor]:
        update_output = {}
        for rouge_key in self.rouge_keys_values:
            for stat in ["fmeasure", "precision", "recall"]:
                state = getattr(self, f"rouge{rouge_key}_{stat}")
                if not len(state):
                    update_output[f"rouge{rouge_key}_{stat}"] = []
                    continue
                # one stack of the 0-d entries; a synced state is one gathered vector
                joined = torch.stack(state) if all(v.dim() == 0 for v in state) else dim_zero_cat(state)
                update_output[f"rouge{rouge_key}_{stat}"] = joined.tolist()
        return _rouge_score_compute(update_output, self.device)
