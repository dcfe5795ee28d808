"""Word error rate (counterpart of ``metrics_tpu/functional/text/wer.py``)."""
from typing import List, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _count_tensors, _edit_distance, _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device


def _wer_update(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> Tuple[int, int]:
    preds_l, target_l = _validate_text_inputs(preds, target)
    errors = 0
    total = 0
    for pred, tgt in zip(preds_l, target_l):
        pred_tokens: List[str] = pred.split()
        tgt_tokens: List[str] = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += len(tgt_tokens)
    return errors, total


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors.to(torch.float32) / total.to(torch.float32)


def word_error_rate(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]], device=None) -> Tensor:
    """Word error rate for speech recognition (0 = perfect), on ``device`` (``cuda``
    unless named)."""
    device = _resolve_device(device)
    return _wer_compute(*_count_tensors(device, *_wer_update(preds, target)))
