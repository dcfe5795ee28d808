"""InfoLM (counterpart of ``metrics_tpu/functional/text/infolm.py``).

Information measures between per-sentence discrete token distributions produced by
a masked language model (Colombo et al., "InfoLM: A New Metric to Evaluate
Summarization & Data2Text Generation").

The model is a callable

    ``logits_fn(input_ids [B, S], attention_mask [B, S]) -> logits [B, S, V]``

taking numpy ids and giving a tensor (:func:`metrics_tpu_torch.models.bert.torch_mlm_logits_fn`
builds one from a local checkpoint). The distribution builder masks one position at
a time, as the JAX package and the reference do: one forward per position. The
measures run on the logits' device in float32, ``nan_to_num`` like the reference.
"""
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _input_ids_idf, _tokens_idf
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device, to_tensor
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)

LogitsFn = Callable[[np.ndarray, np.ndarray], Tensor]


class _InformationMeasure:
    """Dispatcher for the nine InfoLM information measures (nan -> 0)."""

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` expected one of {_ALLOWED_INFORMATION_MEASURE}, "
                f"got {information_measure}."
            )
        self.information_measure = information_measure
        needs_alpha = ("alpha_divergence", "ab_divergence", "renyi_divergence")
        if information_measure in needs_alpha and not isinstance(alpha, float):
            raise ValueError(f"Parameter `alpha` is expected to be defined for {information_measure}.")
        if information_measure in ("beta_divergence", "ab_divergence") and not isinstance(beta, float):
            raise ValueError(f"Parameter `beta` is expected to be defined for {information_measure}.")
        if information_measure == "alpha_divergence" and (not isinstance(alpha, float) or alpha in [0, 1]):
            raise ValueError(
                f"Parameter `alpha` is expected to be float differened from 0 and 1 for {information_measure}."
            )
        if information_measure == "beta_divergence" and (not isinstance(beta, float) or beta in [0, -1]):
            raise ValueError(
                f"Parameter `beta` is expected to be float differened from 0 and -1 for {information_measure}."
            )
        if information_measure == "ab_divergence" and (
            alpha is None or beta is None or 0 in [alpha, beta, alpha + beta]
        ):
            raise ValueError(
                f"Parameters `alpha`, `beta` and their sum are expected to be differened from 0 for "
                f"{information_measure}."
            )
        if information_measure == "renyi_divergence" and (not isinstance(alpha, float) or alpha == 1):
            raise ValueError(f"Parameter `alpha` is expected to be float differened from 1 for {information_measure}.")
        self.alpha = alpha or 0.0
        self.beta = beta or 0.0

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        fn = getattr(self, f"_calculate_{self.information_measure}")
        return torch.nan_to_num(fn(preds_distribution, target_distribution))

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        # sets alpha for good, as the JAX package and the reference do
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.max(torch.abs(t - p), dim=-1).values

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sqrt(p * t).sum(-1), 0, 1))


def masked_lm_distribution(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    logits_fn: LogitsFn,
    special_tokens_map: Dict[str, int],
    temperature: float = 0.25,
    idf_weights: Optional[np.ndarray] = None,
    device=None,
) -> Tensor:
    """Per-sentence discrete distribution over the vocabulary (reference :355-404).

    Masks each position in turn, reads the masked position's softmax at
    ``temperature``, zeroes special-token positions (pad/sep/cls) and averages
    (idf-weighted when ``idf_weights`` is given). Logits that are not a tensor go to
    ``device``.
    """
    input_ids = np.asarray(input_ids)
    seq_len = input_ids.shape[1]
    token_mask = ~(
        (input_ids == special_tokens_map["pad_token_id"])
        | (input_ids == special_tokens_map["sep_token_id"])
        | (input_ids == special_tokens_map["cls_token_id"])
    )
    per_position = []
    for mask_idx in range(seq_len):
        masked = input_ids.copy()
        masked[:, mask_idx] = special_tokens_map["mask_token_id"]
        logits = to_tensor(logits_fn(masked, attention_mask), device)[:, mask_idx, :].to(torch.float32)
        device = logits.device
        prob = torch.softmax(logits / temperature, dim=-1)
        if idf_weights is not None:
            prob = prob * torch.as_tensor(idf_weights[:, mask_idx, None], device=device)
        per_position.append(prob)
    stacked = torch.stack(per_position, dim=1)  # [B, S, V]
    mask_t = torch.as_tensor(token_mask, device=device)
    stacked = stacked * mask_t.to(stacked.dtype)[..., None]
    if idf_weights is not None:
        denom = torch.sum(mask_t * torch.as_tensor(idf_weights, device=device), dim=1)
    else:
        denom = torch.sum(mask_t.to(stacked.dtype), dim=1)
    return stacked.sum(dim=1) / denom[:, None]


def _load_transformers_mlm(model_name_or_path: str, device=None):
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`infolm` with `model_name_or_path` requires `transformers`. Either install it or pass `logits_fn` "
            "+ `tokenizer_fn` + `special_tokens_map`."
        )
    device = _resolve_device(device)
    from transformers import AutoModelForMaskedLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    model = AutoModelForMaskedLM.from_pretrained(model_name_or_path)
    model.eval()
    model.to(device)

    def logits_fn(input_ids: np.ndarray, attention_mask: np.ndarray) -> Tensor:
        with torch.no_grad(), fp32_exact():
            return model(torch.as_tensor(input_ids, device=device), torch.as_tensor(attention_mask, device=device)).logits

    def tokenizer_fn(sentences: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        batch = tokenizer(
            list(sentences), padding="max_length", max_length=max_length, truncation=True, return_tensors="np"
        )
        return batch["input_ids"], batch["attention_mask"]

    special = {
        "mask_token_id": tokenizer.mask_token_id,
        "pad_token_id": tokenizer.pad_token_id,
        "sep_token_id": tokenizer.sep_token_id,
        "cls_token_id": tokenizer.cls_token_id,
    }
    return logits_fn, tokenizer_fn, special


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
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
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM: information measure between masked-LM token distributions.

    Args:
        preds: hypothesis corpus.
        target: reference corpus.
        model_name_or_path: HF masked-LM to load when no ``logits_fn`` is given.
        temperature: softmax calibration temperature.
        information_measure: one of the nine supported measures.
        idf: weight positions by inverse document frequency (computed on ``target``).
        alpha: parameter of the alpha/AB/Rényi divergences.
        beta: parameter of the beta/AB divergences.
        max_length: tokenizer pad/truncation length (default 512).
        return_sentence_level_score: also return the per-sentence values.
        logits_fn: custom masked-LM forward ``(input_ids, attention_mask) -> logits``.
        tokenizer_fn: custom ``(sentences, max_length) -> (input_ids, attention_mask)``.
        special_tokens_map: ids of the ``mask/pad/sep/cls`` tokens (required with
            ``logits_fn``).
        device: where the default model runs, and where logits that are not tensors
            go; ``cuda`` by default.
    """
    if temperature <= 0:
        raise ValueError(f"Argument `temperature` expected to be a positive number, got {temperature}")
    measure = _InformationMeasure(information_measure, alpha, beta)
    max_length = max_length or 512

    if logits_fn is None:
        logits_fn, tokenizer_fn, special_tokens_map = _load_transformers_mlm(model_name_or_path, device)
    if tokenizer_fn is None or special_tokens_map is None:
        raise ValueError("`logits_fn` requires `tokenizer_fn` and `special_tokens_map` to be provided as well.")

    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, got {len(preds_l)} and {len(target_l)}"
        )

    p_ids, p_mask = tokenizer_fn(preds_l, max_length)
    t_ids, t_mask = tokenizer_fn(target_l, max_length)

    p_idf = t_idf = None
    if idf:
        idf_map = _tokens_idf(np.asarray(t_ids))
        p_idf = _input_ids_idf(np.asarray(p_ids), idf_map)
        t_idf = _input_ids_idf(np.asarray(t_ids), idf_map)

    preds_distribution = masked_lm_distribution(p_ids, p_mask, logits_fn, special_tokens_map, temperature, p_idf,
                                                device)
    target_distribution = masked_lm_distribution(t_ids, t_mask, logits_fn, special_tokens_map, temperature, t_idf,
                                                 preds_distribution.device)

    per_sentence = measure(preds_distribution, target_distribution)
    score = per_sentence.mean().to(torch.float32)
    if return_sentence_level_score:
        return score, per_sentence.to(torch.float32)
    return score
