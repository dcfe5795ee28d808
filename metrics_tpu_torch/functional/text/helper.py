"""Shared text machinery: input checks, token ids and the edit distance
(counterpart of ``metrics_tpu/functional/text/helper.py``).

The string metrics are host code in both packages: tokenising, n-gram counting and
the dynamic programs run in Python and numpy, and only the accumulated statistics
become tensors on the metric's device. The Levenshtein row recurrence is
vectorised over the inner dimension with the prefix-min form
``row[j] = j + cummin_k<=j (cand[k] - k)`` of the sequential insertion term.
"""
import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch


def _validate_text_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]
) -> Tuple[List[str], List[str]]:
    """``str | Sequence[str]`` inputs as two lists of equal length."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    preds, target = list(preds), list(target)
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, got {len(preds)} and {len(target)}"
        )
    return preds, target


def _token_ids(tokens: Sequence, vocab: Dict) -> np.ndarray:
    """Hashable tokens as dense int32 ids; the shared ``vocab`` grows in place."""
    return np.fromiter(
        (vocab.setdefault(tok, len(vocab)) for tok in tokens), dtype=np.int32, count=len(tokens)
    )


def _levenshtein_ids(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance between two id sequences, one vectorised step per DP row.

    With the previous row ``P`` and substitution costs ``c[j]``,
    ``cand[j] = min(P[j] + 1, P[j-1] + c[j])``; the insertion chain then folds in as
    ``row[j] = j + cummin_k<=j (m[k] - k)`` with ``m[0] = i`` and ``m[k] = cand[k]``.
    """
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if n > m:  # loop over the shorter sequence, vectorise the longer row
        a, b, n, m = b, a, m, n
    offsets = np.arange(m + 1, dtype=np.int64)
    prev = offsets.copy()
    for i in range(1, n + 1):
        cost = (b != a[i - 1]).astype(np.int64)
        cand = np.minimum(prev[1:] + 1, prev[:-1] + cost)
        t = np.empty(m + 1, dtype=np.int64)
        t[0] = i
        np.subtract(cand, offsets[1:], out=t[1:])
        np.minimum.accumulate(t, out=t)
        prev = t + offsets
    return int(prev[m])


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Edit distance between two token sequences."""
    vocab: Dict = {}
    return _levenshtein_ids(_token_ids(prediction_tokens, vocab), _token_ids(reference_tokens, vocab))


def _tokens_idf(input_ids: np.ndarray) -> Dict:
    """Inverse document frequencies over a tokenised corpus, ``log((N+1)/(df+1))``;
    ``"__default__"`` holds the value of a token outside the corpus, ``log(N+1)``."""
    num_sentences = input_ids.shape[0]
    counter: Counter = Counter()
    for row in input_ids:
        counter.update(set(row.tolist()))
    idf: Dict = {idx: math.log((num_sentences + 1) / (occurrence + 1)) for idx, occurrence in counter.items()}
    idf["__default__"] = math.log(num_sentences + 1)
    return idf


def _input_ids_idf(input_ids: np.ndarray, idf_map: Dict) -> np.ndarray:
    """Per-position idf weights of a tokenised batch (unknown ids take the default)."""
    default = idf_map["__default__"]
    return np.vectorize(lambda t: idf_map.get(int(t), default))(input_ids).astype(np.float32)


def _count_tensors(device, *counts: int) -> Tuple:
    """Host counts as int64 tensors on ``device`` (the port's count dtype)."""
    return tuple(torch.tensor(c, dtype=torch.int64, device=device) for c in counts)
