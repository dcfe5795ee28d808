"""InfoLM (counterpart of ``metrics_tpu/text/infolm.py``): the host-side corpus of
:class:`~metrics_tpu_torch.text.bert.BERTScore`; the masked-LM sweep runs once at
``compute``."""
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.infolm import LogitsFn, _InformationMeasure, _load_transformers_mlm, infolm


class InfoLM(Metric):
    """Information measure between masked-LM token distributions.

    Args:
        model_name_or_path: HF masked-LM to load on the metric's device when no
            ``logits_fn`` is given.
        temperature: softmax calibration temperature.
        information_measure: one of the nine supported measures.
        idf: idf-weight positions (computed on the reference corpus).
        alpha: parameter of the alpha/AB/Rényi divergences.
        beta: parameter of the beta/AB divergences.
        max_length: tokenizer pad/truncation length (default 512).
        return_sentence_level_score: also return the per-sentence values.
        logits_fn / tokenizer_fn / special_tokens_map: custom model interface, see
            :mod:`metrics_tpu_torch.functional.text.infolm`.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _host_side_update = True

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        max_length: Optional[int] = None,
        return_sentence_level_score: bool = False,
        logits_fn: Optional[LogitsFn] = None,
        tokenizer_fn: Optional[Callable[[Sequence[str], int], Tuple[np.ndarray, np.ndarray]]] = None,
        special_tokens_map: Optional[Dict[str, int]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _InformationMeasure(information_measure, alpha, beta)  # validate early
        if temperature <= 0:
            raise ValueError(f"Argument `temperature` expected to be a positive number, got {temperature}")
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.return_sentence_level_score = return_sentence_level_score
        self.logits_fn = logits_fn
        self.tokenizer_fn = tokenizer_fn
        self.special_tokens_map = special_tokens_map
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

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if self.logits_fn is None:
            # load (and cache) the masked LM once: per-call loading would read the
            # whole checkpoint from disk on every compute
            self.logits_fn, self.tokenizer_fn, self.special_tokens_map = _load_transformers_mlm(
                self.model_name_or_path, self.device
            )
        return infolm(
            list(self._preds_corpus),
            list(self._target_corpus),
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            max_length=self.max_length,
            return_sentence_level_score=self.return_sentence_level_score,
            logits_fn=self.logits_fn,
            tokenizer_fn=self.tokenizer_fn,
            special_tokens_map=self.special_tokens_map,
            device=self.device,
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, len(self._preds_corpus), len(self._target_corpus)))
