"""BLEU (counterpart of ``metrics_tpu/functional/text/bleu.py``).

N-gram counting is host code; the statistics are four count tensors, the clipped
matches and the candidate n-grams of each order and the two corpus lengths (int64,
the port's count dtype). The compute is the JAX package's branchless one, in
float32: a safe log and a ``where`` in place of an early return on a zero match
count, so that it runs without reading a value on the host.
"""
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import _resolve_device


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    """Counter of all 1..n_gram-grams (tuple keys) of a token sequence."""
    ngram_counter: Counter = Counter()
    for n in range(1, n_gram + 1):
        for j in range(len(tokens) - n + 1):
            ngram_counter[tuple(tokens[j : j + n])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[List[int], List[int], int, int]:
    """A batch's statistics on the host: (numerator, denominator, preds_len, target_len).

    ``numerator[k]`` counts the reference-clipped (k+1)-gram matches,
    ``denominator[k]`` the candidate (k+1)-grams; ``target_len`` takes the reference
    closest in length (the first of a tie).
    """
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]

    numerator = [0] * n_gram
    denominator = [0] * n_gram
    preds_len = 0
    target_len = 0
    for pred, targets in zip(preds_tok, target_tok):
        preds_len += len(pred)
        len_diffs = [abs(len(pred) - len(tgt)) for tgt in targets]
        target_len += len(targets[len_diffs.index(min(len_diffs))])

        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)
        clipped = preds_counter & target_counter

        for key, cnt in clipped.items():
            numerator[len(key) - 1] += cnt
        for key, cnt in preds_counter.items():
            denominator[len(key) - 1] += cnt
    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    preds_len, target_len = preds_len.to(torch.float32), target_len.to(torch.float32)
    numerator, denominator = numerator.to(torch.float32), denominator.to(torch.float32)
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision = torch.cat([numerator[:1] / denominator[:1], precision[1:]])
    else:
        precision = numerator / denominator
    # if any clipped-match count is zero the score is exactly 0
    any_zero = torch.min(numerator) == 0.0
    safe_precision = torch.where(precision > 0, precision, 1.0)
    log_precision = torch.tensor(weights, dtype=torch.float32, device=numerator.device) * torch.log(safe_precision)
    geometric_mean = torch.exp(torch.sum(log_precision))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - target_len / preds_len))
    return torch.where(any_zero, 0.0, brevity_penalty * geometric_mean)


def _bleu_statistics(device, numerator, denominator, preds_len, target_len) -> Tuple[Tensor, ...]:
    """The host statistics as int64 tensors on ``device``, in compute's order."""
    return tuple(
        torch.tensor(v, dtype=torch.int64, device=device) for v in (preds_len, target_len, numerator, denominator)
    )


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device=None,
) -> Tensor:
    """BLEU of machine-translated text against one or more references, on ``device``
    (``cuda`` unless named).

    Args:
        preds: machine-translated corpus.
        target: per-sample iterable of reference translations.
        n_gram: largest n-gram order.
        smooth: add-one smoothing of the orders above 1.
        weights: per-order weights (uniform ``1/n_gram`` by default).
    """
    device = _resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    stats = _bleu_statistics(device, *_bleu_score_update(preds_, target_, n_gram, _tokenize_fn))
    return _bleu_score_compute(*stats, n_gram, weights, smooth)
