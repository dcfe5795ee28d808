"""Character error rate (counterpart of ``metrics_tpu/functional/text/cer.py``)."""
from typing import Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _count_tensors, _edit_distance, _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device


def _cer_update(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> Tuple[int, int]:
    preds_l, target_l = _validate_text_inputs(preds, target)
    errors = 0
    total = 0
    for pred, tgt in zip(preds_l, target_l):
        errors += _edit_distance(list(pred), list(tgt))
        total += len(tgt)
    return errors, total


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors.to(torch.float32) / total.to(torch.float32)


def char_error_rate(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]], device=None) -> Tensor:
    """Character error rate for speech and OCR systems (0 = perfect), on ``device``
    (``cuda`` unless named)."""
    device = _resolve_device(device)
    return _cer_compute(*_count_tensors(device, *_cer_update(preds, target)))
