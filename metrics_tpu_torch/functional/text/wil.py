"""Word information lost (counterpart of ``metrics_tpu/functional/text/wil.py``).

The state is the hit count ``hits = sum(max(|ref|, |hyp|)) - edit_errors``, as in
the JAX package.
"""
from typing import Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _count_tensors, _edit_distance, _validate_text_inputs
from metrics_tpu_torch.utils.data import _resolve_device


def _wil_update(preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> Tuple[int, int, int]:
    preds_l, target_l = _validate_text_inputs(preds, target)
    hits = 0
    target_total = 0
    preds_total = 0
    for pred, tgt in zip(preds_l, target_l):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        hits += max(len(tgt_tokens), len(pred_tokens)) - _edit_distance(pred_tokens, tgt_tokens)
        target_total += len(tgt_tokens)
        preds_total += len(pred_tokens)
    return hits, target_total, preds_total


def _wil_compute(hits: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    hits = hits.to(torch.float32)
    return 1 - (hits / target_total.to(torch.float32)) * (hits / preds_total.to(torch.float32))


def word_information_lost(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]], device=None
) -> Tensor:
    """Word information lost, ``1 - (hits/ref_len) * (hits/hyp_len)`` (0 = perfect), on
    ``device`` (``cuda`` unless named)."""
    device = _resolve_device(device)
    return _wil_compute(*_count_tensors(device, *_wil_update(preds, target)))
