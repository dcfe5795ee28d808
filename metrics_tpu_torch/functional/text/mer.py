"""Match error rate (counterpart of ``metrics_tpu/functional/text/mer.py``)."""
from typing import Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _count_tensors, _edit_distance, _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device


def _mer_update(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> Tuple[int, int]:
    preds_l, target_l = _validate_text_inputs(preds, target)
    errors = 0
    total = 0
    for pred, tgt in zip(preds_l, target_l):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    return errors, total


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors.to(torch.float32) / total.to(torch.float32)


def match_error_rate(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]], device=None) -> Tensor:
    """Match error rate, edit errors over max(reference, hypothesis) length (0 = perfect),
    on ``device`` (``cuda`` unless named)."""
    device = _resolve_device(device)
    return _mer_compute(*_count_tensors(device, *_mer_update(preds, target)))
