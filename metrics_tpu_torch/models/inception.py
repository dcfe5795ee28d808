"""FID-variant InceptionV3 feature extractor as an ``nn.Module`` (counterpart of
``metrics_tpu/models/inception.py``).

The torch-fidelity ``FeatureExtractorInceptionV3``: the TF-inception-2015-12-05
architecture with the three FID deltas of the published torch-fidelity/pytorch-fid
code: (a) average pools exclude padding from their divisor, (b) ``Mixed_7c`` uses a
max pool in its pool branch, (c) the classifier has 1008 outputs. Inputs are uint8
RGB ``(N, 3, H, W)``, resized to 299x299 by the TF-1.x bilinear rule (no half-pixel
centers) and normalised to ``(x - 128) / 128``.

Submodule and buffer names follow the torch-fidelity checkpoint
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``, ``fc.weight``), so its
state dict loads as it is. Batch norm is inference-only and folded into a scale and
shift as in the JAX package. Convolutions and matmuls run in full float32 (TF32 off)
unless ``compute_dtype=torch.bfloat16``: bf16 operands with float32 accumulation,
batch norm and relu in float32. cuDNN returns a bf16 convolution's output in bf16, so
that path rounds each convolution's output to bf16 before the batch norm, where the
JAX package's ``preferred_element_type`` keeps it in float32.

Weights come only from a local file (``METRICS_TPU_INCEPTION_WEIGHTS``, ``.npz`` or
``.pth``) or from :func:`random_inception_state` (seeded; the same draws as the JAX
package's ``random_inception_params``). Nothing is downloaded.
"""
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.models._io import load_checkpoint_state
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device

_BN_EPS = 1e-3
FEATURE_DIMS = {64: 64, 192: 192, 768: 768, 2048: 2048, "logits_unbiased": 1008}
_VALID_FEATURES = ("logits_unbiased", 64, 192, 768, 2048, "logits")

# Every conv (out, in, kh, kw) of the torch-fidelity InceptionV3
_CONV_SHAPES: Dict[str, tuple] = {
    "Conv2d_1a_3x3": (32, 3, 3, 3), "Conv2d_2a_3x3": (32, 32, 3, 3), "Conv2d_2b_3x3": (64, 32, 3, 3),
    "Conv2d_3b_1x1": (80, 64, 1, 1), "Conv2d_4a_3x3": (192, 80, 3, 3),
    "Mixed_5b.branch1x1": (64, 192, 1, 1), "Mixed_5b.branch5x5_1": (48, 192, 1, 1),
    "Mixed_5b.branch5x5_2": (64, 48, 5, 5), "Mixed_5b.branch3x3dbl_1": (64, 192, 1, 1),
    "Mixed_5b.branch3x3dbl_2": (96, 64, 3, 3), "Mixed_5b.branch3x3dbl_3": (96, 96, 3, 3),
    "Mixed_5b.branch_pool": (32, 192, 1, 1),
    "Mixed_5c.branch1x1": (64, 256, 1, 1), "Mixed_5c.branch5x5_1": (48, 256, 1, 1),
    "Mixed_5c.branch5x5_2": (64, 48, 5, 5), "Mixed_5c.branch3x3dbl_1": (64, 256, 1, 1),
    "Mixed_5c.branch3x3dbl_2": (96, 64, 3, 3), "Mixed_5c.branch3x3dbl_3": (96, 96, 3, 3),
    "Mixed_5c.branch_pool": (64, 256, 1, 1),
    "Mixed_5d.branch1x1": (64, 288, 1, 1), "Mixed_5d.branch5x5_1": (48, 288, 1, 1),
    "Mixed_5d.branch5x5_2": (64, 48, 5, 5), "Mixed_5d.branch3x3dbl_1": (64, 288, 1, 1),
    "Mixed_5d.branch3x3dbl_2": (96, 64, 3, 3), "Mixed_5d.branch3x3dbl_3": (96, 96, 3, 3),
    "Mixed_5d.branch_pool": (64, 288, 1, 1),
    "Mixed_6a.branch3x3": (384, 288, 3, 3), "Mixed_6a.branch3x3dbl_1": (64, 288, 1, 1),
    "Mixed_6a.branch3x3dbl_2": (96, 64, 3, 3), "Mixed_6a.branch3x3dbl_3": (96, 96, 3, 3),
    "Mixed_6b.branch1x1": (192, 768, 1, 1), "Mixed_6b.branch7x7_1": (128, 768, 1, 1),
    "Mixed_6b.branch7x7_2": (128, 128, 1, 7), "Mixed_6b.branch7x7_3": (192, 128, 7, 1),
    "Mixed_6b.branch7x7dbl_1": (128, 768, 1, 1), "Mixed_6b.branch7x7dbl_2": (128, 128, 7, 1),
    "Mixed_6b.branch7x7dbl_3": (128, 128, 1, 7), "Mixed_6b.branch7x7dbl_4": (128, 128, 7, 1),
    "Mixed_6b.branch7x7dbl_5": (192, 128, 1, 7), "Mixed_6b.branch_pool": (192, 768, 1, 1),
    "Mixed_6c.branch1x1": (192, 768, 1, 1), "Mixed_6c.branch7x7_1": (160, 768, 1, 1),
    "Mixed_6c.branch7x7_2": (160, 160, 1, 7), "Mixed_6c.branch7x7_3": (192, 160, 7, 1),
    "Mixed_6c.branch7x7dbl_1": (160, 768, 1, 1), "Mixed_6c.branch7x7dbl_2": (160, 160, 7, 1),
    "Mixed_6c.branch7x7dbl_3": (160, 160, 1, 7), "Mixed_6c.branch7x7dbl_4": (160, 160, 7, 1),
    "Mixed_6c.branch7x7dbl_5": (192, 160, 1, 7), "Mixed_6c.branch_pool": (192, 768, 1, 1),
    "Mixed_6d.branch1x1": (192, 768, 1, 1), "Mixed_6d.branch7x7_1": (160, 768, 1, 1),
    "Mixed_6d.branch7x7_2": (160, 160, 1, 7), "Mixed_6d.branch7x7_3": (192, 160, 7, 1),
    "Mixed_6d.branch7x7dbl_1": (160, 768, 1, 1), "Mixed_6d.branch7x7dbl_2": (160, 160, 7, 1),
    "Mixed_6d.branch7x7dbl_3": (160, 160, 1, 7), "Mixed_6d.branch7x7dbl_4": (160, 160, 7, 1),
    "Mixed_6d.branch7x7dbl_5": (192, 160, 1, 7), "Mixed_6d.branch_pool": (192, 768, 1, 1),
    "Mixed_6e.branch1x1": (192, 768, 1, 1), "Mixed_6e.branch7x7_1": (192, 768, 1, 1),
    "Mixed_6e.branch7x7_2": (192, 192, 1, 7), "Mixed_6e.branch7x7_3": (192, 192, 7, 1),
    "Mixed_6e.branch7x7dbl_1": (192, 768, 1, 1), "Mixed_6e.branch7x7dbl_2": (192, 192, 7, 1),
    "Mixed_6e.branch7x7dbl_3": (192, 192, 1, 7), "Mixed_6e.branch7x7dbl_4": (192, 192, 7, 1),
    "Mixed_6e.branch7x7dbl_5": (192, 192, 1, 7), "Mixed_6e.branch_pool": (192, 768, 1, 1),
    "Mixed_7a.branch3x3_1": (192, 768, 1, 1), "Mixed_7a.branch3x3_2": (320, 192, 3, 3),
    "Mixed_7a.branch7x7x3_1": (192, 768, 1, 1), "Mixed_7a.branch7x7x3_2": (192, 192, 1, 7),
    "Mixed_7a.branch7x7x3_3": (192, 192, 7, 1), "Mixed_7a.branch7x7x3_4": (192, 192, 3, 3),
    "Mixed_7b.branch1x1": (320, 1280, 1, 1), "Mixed_7b.branch3x3_1": (384, 1280, 1, 1),
    "Mixed_7b.branch3x3_2a": (384, 384, 1, 3), "Mixed_7b.branch3x3_2b": (384, 384, 3, 1),
    "Mixed_7b.branch3x3dbl_1": (448, 1280, 1, 1), "Mixed_7b.branch3x3dbl_2": (384, 448, 3, 3),
    "Mixed_7b.branch3x3dbl_3a": (384, 384, 1, 3), "Mixed_7b.branch3x3dbl_3b": (384, 384, 3, 1),
    "Mixed_7b.branch_pool": (192, 1280, 1, 1),
    "Mixed_7c.branch1x1": (320, 2048, 1, 1), "Mixed_7c.branch3x3_1": (384, 2048, 1, 1),
    "Mixed_7c.branch3x3_2a": (384, 384, 1, 3), "Mixed_7c.branch3x3_2b": (384, 384, 3, 1),
    "Mixed_7c.branch3x3dbl_1": (448, 2048, 1, 1), "Mixed_7c.branch3x3dbl_2": (384, 448, 3, 3),
    "Mixed_7c.branch3x3dbl_3a": (384, 384, 1, 3), "Mixed_7c.branch3x3dbl_3b": (384, 384, 3, 1),
    "Mixed_7c.branch_pool": (192, 2048, 1, 1),
}


def _axis_matrix(in_size: int, out_size: int, device) -> Tensor:
    """The (out, in) matrix of the TF-1.x bilinear rule along one axis: ``src = dst * in / out``."""
    src = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    frac = src - i0.to(torch.float32)
    rows = torch.arange(out_size, device=device)
    w = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    w.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    w.index_put_((rows, i1), frac, accumulate=True)
    return w


def _tf1_bilinear_resize(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """TF-1.x bilinear resize (align_corners=False, NO half-pixel centers) of NCHW float ``x``.

    ``F.interpolate(align_corners=False)`` uses half-pixel centers and gives other
    features. The resize is two matmuls with the interpolation matrices; at the
    output size it is the identity and is skipped.
    """
    _, _, in_h, in_w = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    wy = _axis_matrix(in_h, out_h, x.device)
    wx = _axis_matrix(in_w, out_w, x.device)
    with fp32_exact():
        return torch.matmul(torch.matmul(wy, x), wx.T)


class _FrozenBatchNorm(nn.Module):
    """Inference batch norm: the checkpoint's four per-channel buffers, no update."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class _ConvBN(nn.Module):
    """Conv (no bias) + inference batch norm (eps 1e-3) + relu, NCHW."""

    def __init__(self, name: str, stride: int = 1, padding: Union[int, Tuple[int, int]] = 0) -> None:
        super().__init__()
        out_c, in_c, kh, kw = _CONV_SHAPES[name]
        self.conv = nn.Conv2d(in_c, out_c, (kh, kw), stride=stride, padding=padding, bias=False)
        self.bn = _FrozenBatchNorm(out_c)

    def forward(self, x: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
        weight = self.conv.weight
        if dtype is not None:
            x, weight = x.to(dtype), weight.to(dtype)
        y = F.conv2d(x, weight, None, self.conv.stride, self.conv.padding).to(torch.float32)
        scale = self.bn.weight / torch.sqrt(self.bn.running_var + _BN_EPS)
        shift = self.bn.bias - self.bn.running_mean * scale
        out = F.relu(y * scale[None, :, None, None] + shift[None, :, None, None])
        return out.to(dtype) if dtype is not None else out


def _avg_pool_exclude_pad(x: Tensor) -> Tensor:
    """3x3 stride-1 pad-1 average pool with padding excluded from the divisor."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _InceptionA(nn.Module):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.branch1x1 = _ConvBN(f"{name}.branch1x1")
        self.branch5x5_1 = _ConvBN(f"{name}.branch5x5_1")
        self.branch5x5_2 = _ConvBN(f"{name}.branch5x5_2", padding=2)
        self.branch3x3dbl_1 = _ConvBN(f"{name}.branch3x3dbl_1")
        self.branch3x3dbl_2 = _ConvBN(f"{name}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3 = _ConvBN(f"{name}.branch3x3dbl_3", padding=1)
        self.branch_pool = _ConvBN(f"{name}.branch_pool")

    def forward(self, x: Tensor, dtype=None) -> Tensor:
        b1 = self.branch1x1(x, dtype)
        b5 = self.branch5x5_2(self.branch5x5_1(x, dtype), dtype)
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x, dtype), dtype), dtype)
        bp = self.branch_pool(_avg_pool_exclude_pad(x), dtype)
        return torch.cat([b1, b5, b3, bp], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.branch3x3 = _ConvBN(f"{name}.branch3x3", stride=2)
        self.branch3x3dbl_1 = _ConvBN(f"{name}.branch3x3dbl_1")
        self.branch3x3dbl_2 = _ConvBN(f"{name}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3 = _ConvBN(f"{name}.branch3x3dbl_3", stride=2)

    def forward(self, x: Tensor, dtype=None) -> Tensor:
        b3 = self.branch3x3(x, dtype)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x, dtype), dtype), dtype)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.branch1x1 = _ConvBN(f"{name}.branch1x1")
        self.branch7x7_1 = _ConvBN(f"{name}.branch7x7_1")
        self.branch7x7_2 = _ConvBN(f"{name}.branch7x7_2", padding=(0, 3))
        self.branch7x7_3 = _ConvBN(f"{name}.branch7x7_3", padding=(3, 0))
        self.branch7x7dbl_1 = _ConvBN(f"{name}.branch7x7dbl_1")
        self.branch7x7dbl_2 = _ConvBN(f"{name}.branch7x7dbl_2", padding=(3, 0))
        self.branch7x7dbl_3 = _ConvBN(f"{name}.branch7x7dbl_3", padding=(0, 3))
        self.branch7x7dbl_4 = _ConvBN(f"{name}.branch7x7dbl_4", padding=(3, 0))
        self.branch7x7dbl_5 = _ConvBN(f"{name}.branch7x7dbl_5", padding=(0, 3))
        self.branch_pool = _ConvBN(f"{name}.branch_pool")

    def forward(self, x: Tensor, dtype=None) -> Tensor:
        b1 = self.branch1x1(x, dtype)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x, dtype), dtype), dtype)
        bd = self.branch7x7dbl_1(x, dtype)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd, dtype)
        bp = self.branch_pool(_avg_pool_exclude_pad(x), dtype)
        return torch.cat([b1, b7, bd, bp], dim=1)


class _InceptionD(nn.Module):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.branch3x3_1 = _ConvBN(f"{name}.branch3x3_1")
        self.branch3x3_2 = _ConvBN(f"{name}.branch3x3_2", stride=2)
        self.branch7x7x3_1 = _ConvBN(f"{name}.branch7x7x3_1")
        self.branch7x7x3_2 = _ConvBN(f"{name}.branch7x7x3_2", padding=(0, 3))
        self.branch7x7x3_3 = _ConvBN(f"{name}.branch7x7x3_3", padding=(3, 0))
        self.branch7x7x3_4 = _ConvBN(f"{name}.branch7x7x3_4", stride=2)

    def forward(self, x: Tensor, dtype=None) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x, dtype), dtype)
        b7 = self.branch7x7x3_1(x, dtype)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7, dtype)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class _InceptionE(nn.Module):
    """``pool="max"`` is the FID ``Mixed_7c``: a 3x3 stride-1 pad-1 max pool in the pool branch."""

    def __init__(self, name: str, pool: str) -> None:
        super().__init__()
        self.pool = pool
        self.branch1x1 = _ConvBN(f"{name}.branch1x1")
        self.branch3x3_1 = _ConvBN(f"{name}.branch3x3_1")
        self.branch3x3_2a = _ConvBN(f"{name}.branch3x3_2a", padding=(0, 1))
        self.branch3x3_2b = _ConvBN(f"{name}.branch3x3_2b", padding=(1, 0))
        self.branch3x3dbl_1 = _ConvBN(f"{name}.branch3x3dbl_1")
        self.branch3x3dbl_2 = _ConvBN(f"{name}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3a = _ConvBN(f"{name}.branch3x3dbl_3a", padding=(0, 1))
        self.branch3x3dbl_3b = _ConvBN(f"{name}.branch3x3dbl_3b", padding=(1, 0))
        self.branch_pool = _ConvBN(f"{name}.branch_pool")

    def forward(self, x: Tensor, dtype=None) -> Tensor:
        b1 = self.branch1x1(x, dtype)
        b3 = self.branch3x3_1(x, dtype)
        b3 = torch.cat([self.branch3x3_2a(b3, dtype), self.branch3x3_2b(b3, dtype)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x, dtype), dtype)
        bd = torch.cat([self.branch3x3dbl_3a(bd, dtype), self.branch3x3dbl_3b(bd, dtype)], dim=1)
        pooled = _avg_pool_exclude_pad(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled, dtype)], dim=1)


class FeatureExtractorInceptionV3(nn.Module):
    """The FID InceptionV3, mapping uint8 RGB ``(N, 3, H, W)`` images to one feature tap.

    Args:
        feature: the tap ``forward`` returns: ``64`` (after the first max pool), ``192``
            (after the second), ``768`` (after ``Mixed_6e``), each globally average
            pooled; ``2048`` (the global average pool); ``"logits_unbiased"`` (the fc
            without bias) or ``"logits"``.
        state: name -> array of the torch-fidelity checkpoint (``.npz`` or ``.pth``
            contents, or :func:`random_inception_state`); entries the network does not
            have (``num_batches_tracked``) are ignored.
        compute_dtype: ``None`` (float32) or ``torch.bfloat16`` for the conv stack.
        device: where the network lives; ``cuda`` by default.
    """

    def __init__(
        self,
        feature: Union[int, str] = 2048,
        state: Optional[Dict[str, object]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> None:
        super().__init__()
        if feature not in _VALID_FEATURES:
            raise ValueError(f"Input to argument `feature` must be one of {_VALID_FEATURES}, but got {feature}.")
        self.feature = feature
        self.compute_dtype = compute_dtype
        self.Conv2d_1a_3x3 = _ConvBN("Conv2d_1a_3x3", stride=2)
        self.Conv2d_2a_3x3 = _ConvBN("Conv2d_2a_3x3")
        self.Conv2d_2b_3x3 = _ConvBN("Conv2d_2b_3x3", padding=1)
        self.Conv2d_3b_1x1 = _ConvBN("Conv2d_3b_1x1")
        self.Conv2d_4a_3x3 = _ConvBN("Conv2d_4a_3x3")
        self.Mixed_5b = _InceptionA("Mixed_5b")
        self.Mixed_5c = _InceptionA("Mixed_5c")
        self.Mixed_5d = _InceptionA("Mixed_5d")
        self.Mixed_6a = _InceptionB("Mixed_6a")
        self.Mixed_6b = _InceptionC("Mixed_6b")
        self.Mixed_6c = _InceptionC("Mixed_6c")
        self.Mixed_6d = _InceptionC("Mixed_6d")
        self.Mixed_6e = _InceptionC("Mixed_6e")
        self.Mixed_7a = _InceptionD("Mixed_7a")
        self.Mixed_7b = _InceptionE("Mixed_7b", pool="avg")
        self.Mixed_7c = _InceptionE("Mixed_7c", pool="max")
        self.fc = nn.Linear(2048, 1008)
        self.requires_grad_(False)
        self.eval()
        if state is not None:
            self.load_state_dict({name: torch.as_tensor(state[name]) for name in self.state_dict()})
        self.to(_resolve_device(device))

    @torch.no_grad()
    def forward(self, x: Tensor, feature: Optional[Union[int, str]] = None) -> Tensor:
        feature = self.feature if feature is None else feature
        dtype = self.compute_dtype
        with fp32_exact():
            x = _tf1_bilinear_resize(x.to(torch.float32), 299, 299)
            x = (x - 128.0) / 128.0

            x = self.Conv2d_1a_3x3(x, dtype)
            x = self.Conv2d_2a_3x3(x, dtype)
            x = self.Conv2d_2b_3x3(x, dtype)
            x = F.max_pool2d(x, 3, stride=2)
            if feature == 64:
                return x.to(torch.float32).mean(dim=(2, 3))
            x = self.Conv2d_3b_1x1(x, dtype)
            x = self.Conv2d_4a_3x3(x, dtype)
            x = F.max_pool2d(x, 3, stride=2)
            if feature == 192:
                return x.to(torch.float32).mean(dim=(2, 3))
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                          self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
                x = block(x, dtype)
            if feature == 768:
                return x.to(torch.float32).mean(dim=(2, 3))
            x = self.Mixed_7a(x, dtype)
            x = self.Mixed_7b(x, dtype)
            x = self.Mixed_7c(x, dtype)
            x = x.to(torch.float32).mean(dim=(2, 3))  # global average pool -> (N, 2048)
            if feature == 2048:
                return x
            logits = x @ self.fc.weight.T
            if feature == "logits_unbiased":
                return logits
            return logits + self.fc.bias


def random_inception_state(seed: int = 0) -> Dict[str, np.ndarray]:
    """Correctly shaped random weights (no weights file), drawn from
    ``np.random.RandomState(seed)`` in the JAX package's order, so both packages get
    the same network. Batch-norm running statistics are non-trivial."""
    rng = np.random.RandomState(seed)
    state: Dict[str, np.ndarray] = {}
    for name, (o, i, kh, kw) in _CONV_SHAPES.items():
        state[f"{name}.conv.weight"] = rng.randn(o, i, kh, kw).astype(np.float32) * 0.05
        state[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
        state[f"{name}.bn.bias"] = rng.randn(o).astype(np.float32) * 0.1
        state[f"{name}.bn.running_mean"] = rng.randn(o).astype(np.float32) * 0.1
        state[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
    state["fc.weight"] = rng.randn(1008, 2048).astype(np.float32) * 0.01
    state["fc.bias"] = np.zeros(1008, np.float32)
    return state


def load_inception_feature_extractor(
    feature: Union[int, str], device=None
) -> Tuple[FeatureExtractorInceptionV3, int]:
    """``(extractor, feature_dim)`` for the pretrained InceptionV3 tap; the weights come
    from the file that ``METRICS_TPU_INCEPTION_WEIGHTS`` names (``.npz`` or ``.pth``)."""
    valid = ("logits_unbiased", 64, 192, 768, 2048)
    if feature not in valid:
        raise ValueError(f"Integer input to argument `feature` must be one of {valid}, but got {feature}.")
    weights_path = os.environ.get("METRICS_TPU_INCEPTION_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        raise ModuleNotFoundError(
            "Pretrained InceptionV3 weights are required for integer `feature` inputs but no weights file"
            " is available (nothing is downloaded). Either set METRICS_TPU_INCEPTION_WEIGHTS to a torch-fidelity"
            " .pth checkpoint or a converted .npz, or pass a callable `feature` extractor ((N, C, H, W) -> (N, D))."
        )
    extractor = FeatureExtractorInceptionV3(feature, state=load_checkpoint_state(weights_path), device=device)
    return extractor, FEATURE_DIMS[feature]
