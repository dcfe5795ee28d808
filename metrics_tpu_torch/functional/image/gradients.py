"""Image gradients (counterpart of ``metrics_tpu/functional/image/gradients.py``)."""
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor


def image_gradients(img, device=None) -> Tuple[Tensor, Tensor]:
    """``(dy, dx)`` first differences of a (B, C, H, W) batch, zero at the far edge."""
    img = to_tensor(img, device)
    if img.ndim != 4:
        raise RuntimeError(f"The size of the image tensor {tuple(img.shape)} is not 4-dimensional")
    img = img.to(torch.float32)
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))
