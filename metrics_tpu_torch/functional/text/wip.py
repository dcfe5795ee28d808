"""Word information preserved (counterpart of ``metrics_tpu/functional/text/wip.py``):
the statistics of word information lost, and ``1 - WIL``."""
from typing import Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _count_tensors
from metrics_tpu_torch.functional.text.wil import _wil_update as _wip_update
from metrics_tpu_torch.utils.data import _resolve_device


def _wip_compute(hits: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    hits = hits.to(torch.float32)
    return (hits / target_total.to(torch.float32)) * (hits / preds_total.to(torch.float32))


def word_information_preserved(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]], device=None
) -> Tensor:
    """Word information preserved, ``(hits/ref_len) * (hits/hyp_len)`` (1 = perfect), on
    ``device`` (``cuda`` unless named)."""
    device = _resolve_device(device)
    return _wip_compute(*_count_tensors(device, *_wip_update(preds, target)))
