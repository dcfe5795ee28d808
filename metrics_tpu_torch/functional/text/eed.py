"""Extended edit distance (counterpart of ``metrics_tpu/functional/text/eed.py``).

The published EED measure (Stanchev, Wang, Ney, WMT 2019): a CDER-style character
alignment grid with a long jump at the reference's blanks, and a coverage penalty
for hypothesis positions visited again.

As in the JAX package, each row's substitution and insertion candidates are one
numpy step with the published float operations, and only the sequential deletion
chain stays a scalar loop, so that the choice among exact ties (which feeds the
coverage count) is the published algorithm's. Host code; the sentence scores are
the state, a float32 list.
"""
import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED between two preprocessed strings (spec: EED.py)."""
    n = len(hyp)
    number_of_visits = [-1] * (n + 1)
    row = [1.0] * (n + 1)
    row[0] = 0.0

    hyp_arr = np.array(list(hyp))
    for w in range(1, len(ref) + 1):
        row_np = np.asarray(row)
        sub_cost = (hyp_arr != ref[w - 1]).astype(np.float64)
        # the candidates that do not depend on next_row itself, in the published float operations
        base = np.minimum(row_np[:-1] + sub_cost, row_np[1:] + insertion)
        next_row = [row[0] + 1.0]
        prev = next_row[0]
        for i in range(1, n + 1):
            prev = min(prev + deletion, base[i - 1])
            next_row.append(prev)

        min_index = next_row.index(min(next_row))
        number_of_visits[min_index] += 1
        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = [min(x, jump) for x in next_row]
        row = next_row

    coverage = rho * sum(x if x >= 0 else 1 for x in number_of_visits)
    return min(1, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing per the published EED util.py rules."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in [(".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")]:
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in [("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")]:
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Best (lowest) per-sentence EED over references, appended to ``sentence_eed``."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[t] if isinstance(t, str) else list(t) for t in target]
    _validate_text_inputs(list(preds), ["x"] * len(target_corpus))  # length check only

    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    preds_p = [preprocess(p) for p in preds]
    target_p = [[preprocess(t) for t in refs] for refs in target_corpus]

    if sentence_eed is None:
        sentence_eed = []
    if 0 in (len(preds_p), len(target_p[0]) if target_p else 0):
        return sentence_eed

    for hypothesis, references in zip(preds_p, target_p):
        best = inf
        for reference in references:
            score = _eed_function(hypothesis, reference, alpha, rho, deletion, insertion)
            if score < best:
                best = score
        sentence_eed.append(best)
    return sentence_eed


def _eed_compute(sentence_level_scores: List[float], device) -> Tensor:
    if len(sentence_level_scores) == 0:
        return torch.tensor(0.0, dtype=torch.float32, device=device)
    return torch.tensor(sum(sentence_level_scores) / len(sentence_level_scores), dtype=torch.float32, device=device)


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device=None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Extended edit distance (lower is better; each sentence's score capped at 1), on
    ``device`` (``cuda`` unless named).

    Args:
        preds: hypothesis corpus.
        target: reference corpus (one or more references per hypothesis).
        language: ``"en"`` or ``"ja"`` preprocessing.
        return_sentence_level_score: also return the per-sentence scores.
        alpha: long-jump penalty.
        rho: coverage (re-visit) penalty.
        deletion: deletion cost.
        insertion: insertion and substitution cost.
    """
    device = _resolve_device(device)
    for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")

    sentence_level_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    average = _eed_compute(sentence_level_scores, device)
    if return_sentence_level_score:
        return average, torch.tensor(sentence_level_scores, dtype=torch.float32, device=device)
    return average
