"""BERTScore (counterpart of ``metrics_tpu/text/bert.py``).

The raw sentences accumulate on the host across updates (string states cannot ride
collectives; ``dist_reduce_fx=None``), and the encoder runs once at ``compute``, on
the metric's device unless the caller's encoder lives elsewhere. For many processes,
shard the corpus and combine the per-sentence outputs downstream.
"""
from typing import Any, Dict, Optional, Sequence, Union

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.bert import (
    _DEFAULT_MODEL,
    TextEncoder,
    _default_transformers_encoder,
    bert_score,
)


class BERTScore(Metric):
    """Token-level greedy cosine matching of contextual embeddings.

    Args:
        encoder: ``(sentences) -> (embeddings, input_ids, attention_mask)``; see
            :mod:`metrics_tpu_torch.functional.text.bert`. Build one on the card with
            :func:`metrics_tpu_torch.models.bert.torch_bert_encoder`.
        model_name_or_path: default ``transformers`` encoder, built on the metric's
            device at the first ``compute`` when no ``encoder`` is given (needs
            locally cached weights).
        idf: weight tokens by inverse document frequency.
        max_length: tokenizer truncation length of the default encoder.
        rescale_with_baseline: linearly rescale with ``baseline``.
        baseline: three floats (precision/recall/f1 baselines).
        return_hash: include a config hash in the output dict.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        encoder: Optional[TextEncoder] = None,
        model_name_or_path: Optional[str] = None,
        idf: bool = False,
        max_length: int = 512,
        rescale_with_baseline: bool = False,
        baseline: Optional[Sequence[float]] = None,
        return_hash: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.encoder = encoder
        self.model_name_or_path = model_name_or_path or _DEFAULT_MODEL
        self.idf = idf
        self.max_length = max_length
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline = baseline
        self.return_hash = return_hash
        self.add_state("_preds_corpus", [], dist_reduce_fx=None)
        self.add_state("_target_corpus", [], dist_reduce_fx=None)

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        preds_l = [preds] if isinstance(preds, str) else list(preds)
        target_l = [target] if isinstance(target, str) else list(target)
        if len(preds_l) != len(target_l):
            raise ValueError(
                f"Expected argument `preds` and `target` to have the same length, got {len(preds_l)}"
                f" and {len(target_l)}"
            )
        self._preds_corpus.extend(preds_l)
        self._target_corpus.extend(target_l)

    def compute(self) -> Dict[str, Union[Tensor, str]]:
        if self.encoder is None:
            # build (and cache) the default encoder once: from_pretrained per call
            # would read the whole model from disk on every compute
            self.encoder = _default_transformers_encoder(self.model_name_or_path, self.max_length, self.device)
        return bert_score(
            list(self._preds_corpus),
            list(self._target_corpus),
            encoder=self.encoder,
            model_name_or_path=self.model_name_or_path,
            idf=self.idf,
            max_length=self.max_length,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline=self.baseline,
            return_hash=self.return_hash,
            device=self.device,
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, len(self._preds_corpus), len(self._target_corpus)))
