"""chrF and chrF++ (counterpart of ``metrics_tpu/functional/text/chrf.py``).

The statistics are six count vectors, ``(n_char_order,)`` and ``(n_word_order,)``
n-gram counts of the predictions, the references and their matches, as in the JAX
package: counted on the host, held as int64 tensors, and turned into the f-score in
float32 on the device.

As in the JAX package, the best reference of a sample is chosen with a strict
``>`` against an initial 0.0, so a sample whose references all score 0 adds nothing
to the reference and matching counts.
"""
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device

_EPS_SMOOTHING = 1e-16
# punctuation set from the published chrF implementation
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split a leading/trailing punctuation char off a word (chrF++ word stream)."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    out: List[str] = []
    for word in sentence.strip().split():
        out.extend(_separate_word_and_punctuation(word))
    return out


def _ngram_counts(tokens: List[str], n_gram_order: int) -> List[Counter]:
    """Per-order n-gram Counters, index k = (k+1)-grams."""
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, n_gram_order + 1)
    ]


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter], np.ndarray, np.ndarray]:
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    char_totals = np.array([sum(c.values()) for c in char_counts], dtype=np.float64)
    word_totals = np.array([sum(c.values()) for c in word_counts], dtype=np.float64)
    return char_counts, word_counts, char_totals, word_totals


def _matches(hyp_counts: List[Counter], ref_counts: List[Counter]) -> np.ndarray:
    return np.array([sum((h & r).values()) for h, r in zip(hyp_counts, ref_counts)], dtype=np.float64)


def _fscore_from_stats(
    matching_char: np.ndarray,
    matching_word: np.ndarray,
    hyp_char: np.ndarray,
    hyp_word: np.ndarray,
    ref_char: np.ndarray,
    ref_word: np.ndarray,
    n_order: float,
    beta: float,
) -> float:
    """Mean per-order F-beta over char and word n-gram orders (host NumPy path)."""

    def _per_order(matching: np.ndarray, hyp: np.ndarray, ref: np.ndarray) -> np.ndarray:
        precision = np.where(hyp > 0, matching / np.maximum(hyp, 1e-300), 0.0)
        recall = np.where(ref > 0, matching / np.maximum(ref, 1e-300), 0.0)
        denom = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denom

    char_f = _per_order(matching_char, hyp_char, ref_char)
    word_f = _per_order(matching_word, hyp_word, ref_word)
    return float((char_f.sum() + word_f.sum()) / n_order)


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    collect_sentence_scores: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, Optional[List[float]]]:
    """The six count vectors of a batch (int64 numpy arrays), the best reference of
    each sample, and the sentence scores when asked for."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[t] if isinstance(t, str) else list(t) for t in target]
    _validate_text_inputs(list(preds), ["x"] * len(target_corpus))  # length check only

    n_order = float(n_char_order + n_word_order)
    total_preds_char = np.zeros(n_char_order)
    total_preds_word = np.zeros(n_word_order)
    total_target_char = np.zeros(n_char_order)
    total_target_word = np.zeros(n_word_order)
    total_matching_char = np.zeros(n_char_order)
    total_matching_word = np.zeros(n_word_order)
    sentence_scores: Optional[List[float]] = [] if collect_sentence_scores else None

    for pred, targets in zip(preds, target_corpus):
        p_char_counts, p_word_counts, p_char_tot, p_word_tot = _sentence_counts(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        total_preds_char += p_char_tot
        total_preds_word += p_word_tot

        best_f = 0.0
        best_match_char = np.zeros(n_char_order)
        best_match_word = np.zeros(n_word_order)
        best_tgt_char = np.zeros(n_char_order)
        best_tgt_word = np.zeros(n_word_order)
        for tgt in targets:
            t_char_counts, t_word_counts, t_char_tot, t_word_tot = _sentence_counts(
                tgt, n_char_order, n_word_order, lowercase, whitespace
            )
            match_char = _matches(p_char_counts, t_char_counts)
            match_word = _matches(p_word_counts, t_word_counts)
            f = _fscore_from_stats(
                match_char, match_word, p_char_tot, p_word_tot, t_char_tot, t_word_tot, n_order, beta
            )
            if f > best_f:
                best_f = f
                best_match_char, best_match_word = match_char, match_word
                best_tgt_char, best_tgt_word = t_char_tot, t_word_tot

        if sentence_scores is not None:
            sentence_scores.append(best_f)
        total_target_char += best_tgt_char
        total_target_word += best_tgt_word
        total_matching_char += best_match_char
        total_matching_word += best_match_word

    counts = (total_preds_char, total_preds_word, total_target_char, total_target_word,
              total_matching_char, total_matching_word)
    return (*(c.astype(np.int64) for c in counts), sentence_scores)


def _chrf_score_compute(
    total_preds_char: Tensor,
    total_preds_word: Tensor,
    total_target_char: Tensor,
    total_target_word: Tensor,
    total_matching_char: Tensor,
    total_matching_word: Tensor,
    n_order: float,
    beta: float,
) -> Tensor:
    """Corpus chrF from the six count vectors, branchless, in float32."""

    def _per_order(matching: Tensor, hyp: Tensor, ref: Tensor) -> Tensor:
        matching, hyp, ref = matching.to(torch.float32), hyp.to(torch.float32), ref.to(torch.float32)
        precision = torch.where(hyp > 0, matching / torch.clamp(hyp, min=1e-30), 0.0)
        recall = torch.where(ref > 0, matching / torch.clamp(ref, min=1e-30), 0.0)
        denom = torch.clamp(beta**2 * precision + recall, min=_EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denom

    char_f = _per_order(total_matching_char, total_preds_char, total_target_char)
    word_f = _per_order(total_matching_word, total_preds_word, total_target_word)
    return ((torch.sum(char_f) + torch.sum(word_f)) / n_order).to(torch.float32)


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF (``n_word_order=0``) or chrF++ (``n_word_order=2``, the default), on ``device``
    (``cuda`` unless named)."""
    device = _resolve_device(device)
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    n_order = float(n_char_order + n_word_order)
    (pc, pw, tc, tw, mc, mw, sentence_scores) = _chrf_score_update(
        preds, target, n_char_order, n_word_order, beta, lowercase, whitespace, return_sentence_level_score
    )
    score = _chrf_score_compute(*(torch.from_numpy(c).to(device) for c in (pc, pw, tc, tw, mc, mw)), n_order, beta)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32, device=device)
    return score
