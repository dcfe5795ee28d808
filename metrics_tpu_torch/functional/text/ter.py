"""Translation edit rate (counterpart of ``metrics_tpu/functional/text/ter.py``).

The Tercom algorithm as sacrebleu publishes it: a beam-pruned Levenshtein distance
with an operation trace, the greedy shift search with Tercom's ranking of
candidates, and Tercom's normaliser and tokenizer. Host code; the two totals (the
edits, an int64 count, and the summed average reference length, float32) are the
device state.

As in the JAX package: the memo of edit distances is a per-sentence dict keyed by
the whole hypothesis, the beam applies to every row, and each reference is scored
as the hypothesis against the prediction.
"""
import math
import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device

# Tercom limits
_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_BEAM_WIDTH = 25
# sacrebleu limit
_MAX_SHIFT_CANDIDATES = 1000
_INF = int(1e16)

# edit ops (trace symbols)
_NOTHING, _SUB, _INS, _DEL, _UNDEF = 0, 1, 2, 3, 4


class _TercomTokenizer:
    """Tercom normalizer/tokenizer (spec: tercom Normalizer.java via sacrebleu)."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _beam_levenshtein(pred: Tuple[str, ...], ref: Tuple[str, ...]) -> Tuple[int, Tuple[int, ...]]:
    """Beam-pruned Levenshtein with trace, Tercom op preference (no-op/sub > del > ins).

    Returns (distance, trace-of-ops rewriting ``pred`` into ``ref``); the first row
    is insertions of ``ref``, the first column deletions of ``pred``.
    """
    n, m = len(pred), len(ref)
    # cost/op matrices, rows 0..n, cols 0..m
    cost = [[_INF] * (m + 1) for _ in range(n + 1)]
    op = [[_UNDEF] * (m + 1) for _ in range(n + 1)]
    for j in range(m + 1):
        cost[0][j] = j
        op[0][j] = _INS
    length_ratio = m / n if pred else 1.0
    beam = math.ceil(length_ratio / 2 + _BEAM_WIDTH) if length_ratio / 2 > _BEAM_WIDTH else _BEAM_WIDTH

    for i in range(1, n + 1):
        pseudo_diag = math.floor(i * length_ratio)
        min_j = max(0, pseudo_diag - beam)
        max_j = m + 1 if i == n else min(m + 1, pseudo_diag + beam)
        row, prev = cost[i], cost[i - 1]
        oprow = op[i]
        for j in range(min_j, max_j):
            if j == 0:
                row[0] = prev[0] + 1
                oprow[0] = _DEL
                continue
            if pred[i - 1] == ref[j - 1]:
                sub_cost, sub_op = prev[j - 1], _NOTHING
            else:
                sub_cost, sub_op = prev[j - 1] + 1, _SUB
            best_cost, best_op = row[j], oprow[j]
            for c, o in ((sub_cost, sub_op), (prev[j] + 1, _DEL), (row[j - 1] + 1, _INS)):
                if best_cost > c:
                    best_cost, best_op = c, o
            row[j], oprow[j] = best_cost, best_op

    # backtrack
    trace: List[int] = []
    i, j = n, m
    while i > 0 or j > 0:
        o = op[i][j]
        trace.append(o)
        if o in (_SUB, _NOTHING):
            i -= 1
            j -= 1
        elif o == _INS:
            j -= 1
        elif o == _DEL:
            i -= 1
        else:  # undefined — outside beam; cannot happen for reachable optimum
            raise RuntimeError("TER backtrack left the beam")
    trace.reverse()
    return cost[n][m], tuple(trace)


def _flip_trace(trace: Tuple[int, ...]) -> Tuple[int, ...]:
    """Recipe for rewriting b->a from a->b: swap insertions and deletions."""
    swap = {_INS: _DEL, _DEL: _INS}
    return tuple(swap.get(o, o) for o in trace)


def _trace_to_alignment(trace: Tuple[int, ...]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Alignment map ref_pos -> hyp_pos plus per-position error flags."""
    ref_pos = hyp_pos = -1
    ref_errors: List[int] = []
    hyp_errors: List[int] = []
    alignments: Dict[int, int] = {}
    for o in trace:
        if o == _NOTHING:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(0)
            hyp_errors.append(0)
        elif o == _SUB:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
            hyp_errors.append(1)
        elif o == _INS:
            hyp_pos += 1
            hyp_errors.append(1)
        elif o == _DEL:
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
        else:
            raise ValueError(f"Unknown operation {o!r}")
    return alignments, ref_errors, hyp_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """All (pred_start, target_start, length) with matching word spans, Tercom limits."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_words[pred_start + length - 1] != target_words[target_start + length - 1]:
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    edit_fn,
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of Tercom's greedy shift search; returns (gain, new words, counter)."""
    edit_distance, inverted_trace = edit_fn(tuple(pred_words))
    trace = _flip_trace(inverted_trace)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        # skip unless the hypothesis span is wrong AND the reference span is wrong
        # AND the shift target lies outside the span itself
        if (
            sum(pred_errors[pred_start : pred_start + length]) == 0
            or sum(target_errors[target_start : target_start + length]) == 0
            or pred_start <= alignments[target_start] < pred_start + length
        ):
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            # Tercom ranking: gain, then longest, then earliest pred, then earliest target
            candidate = (
                edit_distance - edit_fn(tuple(shifted_words))[0],
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Number of edits (shifts + beam-Levenshtein) to match hypothesis to reference."""
    if len(target_words) == 0:
        return 0.0

    ref = tuple(target_words)
    memo: Dict[Tuple[str, ...], Tuple[int, Tuple[int, ...]]] = {}

    def edit_fn(hyp: Tuple[str, ...]) -> Tuple[int, Tuple[int, ...]]:
        if hyp not in memo:
            memo[hyp] = _beam_levenshtein(hyp, ref)
        return memo[hyp]

    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, edit_fn, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words

    return float(num_shifts + edit_fn(tuple(input_words))[0])


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best (lowest) edit count over references + average reference length."""
    tgt_lengths = 0.0
    best_num_edits = 2e16
    for tgt_words in target_words:
        # each reference is scored as hypothesis against the prediction (see module docstring)
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words)
    return best_num_edits, avg_tgt_len


def _ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[int, float, Optional[List[float]]]:
    """A batch's total edits (a whole number), summed average reference length and,
    when ``sentence_ter`` is a list, the sentence scores appended to it."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[t] if isinstance(t, str) else list(t) for t in target]
    _validate_text_inputs(list(preds), ["x"] * len(target_corpus))  # length check only

    total_num_edits = 0.0
    total_tgt_length = 0.0
    for pred, tgts in zip(preds, target_corpus):
        tgt_words_ = [tokenizer(t.rstrip()).split() for t in tgts]
        pred_words_ = tokenizer(pred.rstrip()).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        if sentence_ter is not None:
            sentence_ter.append(_ter_score_from_statistics(num_edits, tgt_length))
    return int(total_num_edits), total_tgt_length, sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    total_num_edits = total_num_edits.to(torch.float32)
    return torch.where(
        total_tgt_length > 0,
        total_num_edits / torch.clamp(total_tgt_length, min=1e-30),
        torch.where(total_num_edits > 0, 1.0, 0.0),
    ).to(torch.float32)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Translation edit rate (lower is better, 0 = perfect), on ``device`` (``cuda``
    unless named)."""
    device = _resolve_device(device)
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, tokenizer, sentence_ter)
    score = _ter_compute(
        torch.tensor(total_num_edits, dtype=torch.int64, device=device),
        torch.tensor(total_tgt_length, dtype=torch.float32, device=device),
    )
    if sentence_ter is not None:
        return score, torch.tensor(sentence_ter, dtype=torch.float32, device=device)
    return score
