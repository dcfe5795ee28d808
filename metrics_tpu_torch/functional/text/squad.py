"""SQuAD exact match and F1 (counterpart of ``metrics_tpu/functional/text/squad.py``).

Host code: the official SQuAD v1 normalisation and token-overlap F1. The three
statistics are the device state: the F1 sum (float32), the exact-match count and
the question count (int64).
"""
import re
import string
from collections import Counter
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import _resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation, articles and extra whitespace (official SQuAD)."""
    s = "".join(ch for ch in s.lower() if ch not in _PUNCT)
    return " ".join(_ARTICLES_RE.sub(" ", s).split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _f1_score(predicted_answer: str, target_answer: str) -> float:
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    num_same = sum((Counter(target_tokens) & Counter(predicted_tokens)).values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        # if either is no-answer, F1 is 1 iff they agree
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _squad_input_check(
    preds: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
    targets: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Validate SQuAD-format inputs; return ``{id: prediction_text}`` + qas list."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]

    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )

    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    qas = [{"id": t["id"], "answers": list(t["answers"]["text"])} for t in targets]
    return preds_dict, qas


def _squad_update(preds: Dict[str, str], qas: List[Dict[str, Any]]) -> Tuple[float, int, int]:
    """The sums of each question's best F1 and best exact match over its gold answers,
    and the question count."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for qa in qas:
        total += 1
        if qa["id"] not in preds:
            rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
            continue
        pred = preds[qa["id"]]
        truths = qa["answers"]
        exact_match += max(_exact_match_score(pred, t) for t in truths)
        f1 += max(_f1_score(pred, t) for t in truths)
    return f1, int(exact_match), total


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(
    preds: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
    target: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
    device=None,
) -> Dict[str, Tensor]:
    """SQuAD v1 exact match and F1, both in percent, on ``device`` (``cuda`` unless named)."""
    device = _resolve_device(device)
    preds_dict, qas = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, qas)
    return _squad_compute(
        torch.tensor(f1, dtype=torch.float32, device=device),
        torch.tensor(exact_match, dtype=torch.int64, device=device),
        torch.tensor(total, dtype=torch.int64, device=device),
    )
