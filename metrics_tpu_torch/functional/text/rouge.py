"""ROUGE-N, ROUGE-L and ROUGE-Lsum (counterpart of ``metrics_tpu/functional/text/rouge.py``).

Host code. The LCS dynamic program of rougeL and rougeLsum is vectorised per row in
numpy, as in the JAX package: the left-to-right step ``L[i][j] = max(cand[j],
L[i][j-1])`` is a running maximum, so a row is
``np.maximum.accumulate(max(P[1:], P[:-1] + match))``.

rougeLsum splits sentences with nltk's punkt where nltk and its data are installed,
and with a regular expression otherwise. ``nltk`` is imported only inside the
functions that use it.
"""
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _token_ids
from metrics_tpu_torch.utils.data import _resolve_device
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence-split for rougeLsum: nltk punkt if its data exists, else regex."""
    x = re.sub("<n>", "", x)  # pegasus newline token
    if _NLTK_AVAILABLE:
        try:
            import nltk

            nltk.data.find("tokenizers/punkt.zip")
            return nltk.sent_tokenize(x)
        except LookupError:
            pass
    return [s for s in _SENTENCE_RE.split(x) if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return {"precision": precision, "recall": recall, "fmeasure": 2 * precision * recall / (precision + recall)}


def _lcs_len(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """LCS length via row-vectorized DP (see module docstring)."""
    vocab: Dict[str, int] = {}
    a, b = _token_ids(pred_tokens, vocab), _token_ids(target_tokens, vocab)
    if len(a) == 0 or len(b) == 0:
        return 0
    if len(a) > len(b):  # loop over the shorter sequence, vectorize the longer row
        a, b = b, a
    prev = np.zeros(len(b) + 1, dtype=np.int32)
    for i in range(1, len(a) + 1):
        match = (b == a[i - 1]).astype(np.int32)
        cand = np.maximum(prev[1:], prev[:-1] + match)
        row = np.empty_like(prev)
        row[0] = 0
        np.maximum.accumulate(cand, out=row[1:])
        prev = row
    return int(prev[-1])


def _lcs_table(pred_ids: np.ndarray, target_ids: np.ndarray) -> np.ndarray:
    """Full (target+1, pred+1) LCS table, row-vectorized."""
    table = np.zeros((len(target_ids) + 1, len(pred_ids) + 1), dtype=np.int32)
    for i in range(1, len(target_ids) + 1):
        match = (pred_ids == target_ids[i - 1]).astype(np.int32)
        cand = np.maximum(table[i - 1, 1:], table[i - 1, :-1] + match)
        np.maximum.accumulate(cand, out=table[i, 1:])
    return table


def _backtracked_lcs_indices(pred_ids: np.ndarray, target_ids: np.ndarray) -> List[int]:
    """Indices into ``target`` of one longest common subsequence."""
    table = _lcs_table(pred_ids, target_ids)
    i, j = len(pred_ids), len(target_ids)
    out: List[int] = []
    while i > 0 and j > 0:
        if pred_ids[i - 1] == target_ids[j - 1]:
            out.append(j - 1)
            i -= 1
            j -= 1
        elif table[j, i - 1] > table[j - 1, i]:
            i -= 1
        else:
            j -= 1
    out.reverse()
    return out


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> List[str]:
    """Union over pred sentences of LCS index sets against one target sentence."""
    vocab: Dict[str, int] = {}
    tgt_ids = _token_ids(target_tokens, vocab)
    union: set = set()
    for pred_tokens in pred_tokens_list:
        union.update(_backtracked_lcs_indices(_token_ids(pred_tokens, vocab), tgt_ids))
    return [target_tokens[i] for i in sorted(union)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> List[str]:
    """Lowercase + strip non-alphanumerics (or user normalizer), split, optional Porter stem."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if isinstance(x, str) and len(x) > 0]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    def _ngrams(tokens: Sequence[str], n: int) -> Counter:
        return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))

    pred_ngrams, target_ngrams = _ngrams(pred, n_gram), _ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum((pred_ngrams & target_ngrams).values())
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    if 0 in (len(pred), len(target)):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(_lcs_len(pred, target), len(pred), len(target))


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Per-sentence union-LCS hits with clipped token counts (google-research scorer)."""
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    pred_counts: Counter = Counter()
    target_counts: Counter = Counter()
    for sentence in pred:
        pred_counts.update(sentence)
    for sentence in target:
        target_counts.update(sentence)

    hits = 0
    for tgt in target:
        for token in _union_lcs(pred, tgt):
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sample scores per rouge key; multi-reference resolved via ``accumulate``.

    ``best`` keeps the reference with the highest fmeasure on the FIRST rouge key (as
    the JAX package does); ``avg`` averages each statistic over the references.
    """
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)
            ]

        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            if "Lsum" in rouge_keys_values:
                target_lsum = [
                    _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                    for s in _split_sentence(target_raw_inner)
                ]
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    scores[key] = _rouge_n_score(pred, tgt, key)
                elif key == "L":
                    scores[key] = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    scores[key] = _rouge_lsum_score(pred_lsum, target_lsum)
            per_ref.append(scores)

        if accumulate == "best":
            first_key = rouge_keys_values[0]
            best_idx = int(np.argmax([ref[first_key]["fmeasure"] for ref in per_ref]))
            for key in rouge_keys_values:
                results[key].append(per_ref[best_idx][key])
        else:  # avg
            for key in rouge_keys_values:
                stats = per_ref[0][key].keys()
                results[key].append(
                    {stat: float(np.mean([ref[key][stat] for ref in per_ref])) for stat in stats}
                )

    return results


def _rouge_score_compute(sentence_results: Dict[str, List[float]], device) -> Dict[str, Tensor]:
    return {
        key: torch.tensor(np.mean(scores), dtype=torch.float32, device=device)
        for key, scores in sentence_results.items()
    }


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device=None,
) -> Dict[str, Tensor]:
    """ROUGE scores for automatic summarization, on ``device`` (``cuda`` unless named).

    Args:
        preds: predicted sentence(s).
        target: reference sentence(s), optionally several per prediction.
        accumulate: several references: ``"best"`` (highest fmeasure) or ``"avg"``.
        use_stemmer: Porter-stem the tokens longer than 3 characters (needs nltk).
        normalizer: a text normaliser (default: lowercase, alphanumerics only).
        tokenizer: a tokenizer (default: split on whitespace).
        rouge_keys: any of ``rouge1``..``rouge9``, ``rougeL``, ``rougeLsum``.
    """
    device = _resolve_device(device)
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if use_stemmer and not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
    stemmer = None
    if use_stemmer:
        import nltk

        stemmer = nltk.stem.porter.PorterStemmer()

    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )

    output: Dict[str, List[float]] = {}
    for key, metrics in sentence_results.items():
        for stat in ["fmeasure", "precision", "recall"]:
            output[f"rouge{key}_{stat}"] = [m[stat] for m in metrics]
    return _rouge_score_compute(output, device)
