"""LPIPS networks as an ``nn.Module`` (counterpart of ``metrics_tpu/models/lpips.py``).

The published LPIPS design (Zhang et al., CVPR 2018): a frozen classification
backbone (VGG16 / AlexNet / SqueezeNet-1.1 feature stacks), channel-unit-normalised
activations at fixed taps, squared differences, learned non-negative 1x1 "lin" heads,
a spatial mean, summed over the taps. Float32 with TF32 off.

Both parts come from local files, nothing is downloaded:

- ``backbone_weights``: a torchvision ``state_dict`` (``features.N.weight``) of the
  chosen net, by path or ``METRICS_TPU_LPIPS_<NET>_WEIGHTS``; its keys are the
  module's own, so it loads as it is;
- ``linear_weights``: lpips-format lin heads (``lin0.model.1.weight`` or
  ``lins.0.model.1.weight``), by path or ``METRICS_TPU_LPIPS_LINEAR_WEIGHTS``.

SqueezeNet's ceil-mode pools are ``max_pool2d(ceil_mode=True)``: the JAX package pads
the right and bottom edges with ``-inf`` up to the next whole window, which gives the
same windows.
"""
import os
from functools import lru_cache
from typing import Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.models._io import load_checkpoint_state
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device

# ImageNet scaling layer constants from the published lpips implementation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# channels at each tap
LPIPS_CHANNELS = {
    "vgg": (64, 128, 256, 512, 512),
    "alex": (64, 192, 384, 256, 256),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

# torchvision ``features`` index -> (out, in, k) of each conv
_VGG_CONVS = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128), 12: (256, 256), 14: (256, 256),
              17: (512, 256), 19: (512, 512), 21: (512, 512), 24: (512, 512), 26: (512, 512), 28: (512, 512)}
_ALEX_CONVS = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3), 10: (256, 256, 3)}
# torchvision squeezenet1_1 ``features`` index -> (in, squeeze, expand) of each fire module
_FIRES = {3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128), 9: (256, 48, 192),
          10: (384, 48, 192), 11: (384, 64, 256), 12: (512, 64, 256)}


def backbone_shapes(net_type: str) -> Dict[str, Tuple[int, ...]]:
    """Every weight and bias of the torchvision backbone, by its ``state_dict`` key."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(key: str, out_c: int, in_c: int, k: int) -> None:
        shapes[f"{key}.weight"], shapes[f"{key}.bias"] = (out_c, in_c, k, k), (out_c,)

    if net_type == "vgg":
        for i, (o, c) in _VGG_CONVS.items():
            conv(f"features.{i}", o, c, 3)
    elif net_type == "alex":
        for i, (o, c, k) in _ALEX_CONVS.items():
            conv(f"features.{i}", o, c, k)
    else:
        conv("features.0", 64, 3, 3)
        for i, (c, s, e) in _FIRES.items():
            conv(f"features.{i}.squeeze", s, c, 1)
            conv(f"features.{i}.expand1x1", e, s, 1)
            conv(f"features.{i}.expand3x3", e, s, 3)
    return shapes


class _Fire(nn.Module):
    def __init__(self, in_c: int, squeeze: int, expand: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(in_c, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


def _conv_relu(conv: nn.Conv2d, x: Tensor, stride: int = 1, padding: int = 0) -> Tensor:
    return F.relu(F.conv2d(x, conv.weight, conv.bias, stride, padding))


class LPIPS(nn.Module):
    """The LPIPS distance network of one backbone.

    Args:
        net_type: ``"vgg"`` | ``"alex"`` | ``"squeeze"``.
        device: where the weights live; ``cuda`` by default.

    ``forward(img1, img2, normalize)`` gives the per-sample distance of two NCHW RGB
    batches: in [-1, 1], or in [0, 1] with ``normalize=True``.
    """

    def __init__(self, net_type: str = "vgg", device=None) -> None:
        super().__init__()
        if net_type not in LPIPS_CHANNELS:
            raise ValueError(f"Argument `net_type` must be one of {tuple(LPIPS_CHANNELS)}, but got {net_type}")
        self.net_type = net_type
        with torch.device(_resolve_device(device)):
            if net_type == "squeeze":
                convs = {"0": nn.Conv2d(3, 64, 3)}
                convs.update({str(i): _Fire(*spec) for i, spec in _FIRES.items()})
            else:
                table = _VGG_CONVS if net_type == "vgg" else _ALEX_CONVS
                convs = {str(i): nn.Conv2d(spec[1], spec[0], spec[2] if len(spec) > 2 else 3)
                         for i, spec in table.items()}
            self.features = nn.ModuleDict(convs)
            self.lins = nn.ParameterList(nn.Parameter(torch.zeros(1, c)) for c in LPIPS_CHANNELS[net_type])
            self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
            self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)
        self.eval()

    @classmethod
    def from_state(cls, net_type: str, state: Dict[str, object], device=None) -> "LPIPS":
        """The network whose weights are ``state``, the port's state dict: the
        torchvision backbone's ``features.*`` entries (others are ignored) and the
        (1, C) lin heads as ``lins.{i}`` (:func:`lpips_state`,
        :func:`metrics_tpu_torch.convert.lpips_state_from_jax`)."""
        model = cls(net_type, device="meta")
        names = list(backbone_shapes(net_type)) + [f"lins.{i}" for i in range(len(LPIPS_CHANNELS[net_type]))]
        missing = [k for k in names if k not in state]
        if missing:
            raise KeyError(f"LPIPS {net_type}: no weights for {missing}")
        model.load_state_dict({k: torch.as_tensor(np.asarray(state[k]), dtype=torch.float32) for k in names},
                              assign=True)
        # non-persistent buffers: load_state_dict leaves them on the meta device
        model.shift = torch.tensor(_SHIFT).reshape(1, 3, 1, 1)
        model.scale = torch.tensor(_SCALE).reshape(1, 3, 1, 1)
        return model.to(_resolve_device(device)).requires_grad_(False)

    def _taps(self, x: Tensor) -> List[Tensor]:
        f = self.features
        taps = []
        if self.net_type == "vgg":
            # taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
            for block in ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)):
                if block[0]:
                    x = F.max_pool2d(x, 2, 2)
                for i in block:
                    x = _conv_relu(f[str(i)], x, padding=1)
                taps.append(x)
        elif self.net_type == "alex":
            # taps after each of the five relus
            x = _conv_relu(f["0"], x, stride=4, padding=2)
            taps.append(x)
            x = _conv_relu(f["3"], F.max_pool2d(x, 3, 2), padding=2)
            taps.append(x)
            x = _conv_relu(f["6"], F.max_pool2d(x, 3, 2), padding=1)
            taps.append(x)
            for i in ("8", "10"):
                x = _conv_relu(f[i], x, padding=1)
                taps.append(x)
        else:
            # seven taps per the published lpips slicing of squeezenet1_1
            x = _conv_relu(f["0"], x, stride=2)
            taps.append(x)
            for group in (("3", "4"), ("6", "7"), ("9",), ("10",), ("11",), ("12",)):
                if group[0] in ("3", "6", "9"):
                    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
                for i in group:
                    x = f[i](x)
                taps.append(x)
        return taps

    @torch.no_grad()
    def forward(self, img1: Tensor, img2: Tensor, normalize: bool = False) -> Tensor:
        with fp32_exact():
            img1, img2 = img1.to(torch.float32), img2.to(torch.float32)
            if normalize:
                img1 = 2 * img1 - 1
                img2 = 2 * img2 - 1
            taps1 = self._taps((img1 - self.shift) / self.scale)
            taps2 = self._taps((img2 - self.shift) / self.scale)
            total = torch.zeros((), device=img1.device)
            for f1, f2, lin_w in zip(taps1, taps2, self.lins):
                n1 = f1 / torch.sqrt(torch.sum(f1**2, dim=1, keepdim=True) + 1e-10)
                n2 = f2 / torch.sqrt(torch.sum(f2**2, dim=1, keepdim=True) + 1e-10)
                diff = (n1 - n2) ** 2
                # lin head: non-negative 1x1 conv, no bias
                res = torch.einsum("nchw,oc->nohw", diff, lin_w)
                total = total + res.mean(dim=(2, 3))[:, 0]
            return total


def linear_weights_from_state_dict(state: Dict[str, np.ndarray], net_type: str) -> List[np.ndarray]:
    """Lin heads, each (1, C), from an lpips-format checkpoint (``lin{i}.model.1.weight``
    or ``lins.{i}.model.1.weight``)."""
    out = []
    for i in range(len(LPIPS_CHANNELS[net_type])):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in state:
                w = np.asarray(state[key])  # (1, C, 1, 1)
                out.append(w.reshape(w.shape[0], w.shape[1]))
                break
        else:
            raise KeyError(f"Could not find lin head {i} in linear weights checkpoint")
    return out


def lpips_state(backbone: Dict[str, np.ndarray], linear_weights: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """The port's state dict of :class:`LPIPS` from a torchvision backbone ``state_dict``
    and the lin heads of :func:`linear_weights_from_state_dict`."""
    state = {k: v for k, v in backbone.items() if k.startswith("features.")}
    state.update({f"lins.{i}": np.asarray(w).reshape(1, -1) for i, w in enumerate(linear_weights)})
    return state


@lru_cache(maxsize=8)
def _load_lpips_cached(net_type: str, backbone_weights: str, linear_weights: str, device: torch.device) -> LPIPS:
    lins = linear_weights_from_state_dict(load_checkpoint_state(linear_weights), net_type)
    return LPIPS.from_state(net_type, lpips_state(load_checkpoint_state(backbone_weights), lins), device)


def load_lpips(
    net_type: str = "vgg",
    backbone_weights: Union[str, None] = None,
    linear_weights: Union[str, None] = None,
    device=None,
) -> LPIPS:
    """The :class:`LPIPS` network of ``net_type`` from local files, on ``device``.

    Networks are cached per (net_type, paths, device), so per-batch functional calls
    neither re-read the multi-hundred-MB checkpoints nor copy them to the card again;
    a cached network is shared, and frozen.
    """
    if net_type not in LPIPS_CHANNELS:
        raise ValueError(f"Argument `net_type` must be one of {tuple(LPIPS_CHANNELS)}, but got {net_type}")
    backbone_weights = backbone_weights or os.environ.get(f"METRICS_TPU_LPIPS_{net_type.upper()}_WEIGHTS")
    linear_weights = linear_weights or os.environ.get("METRICS_TPU_LPIPS_LINEAR_WEIGHTS")
    if not backbone_weights or not os.path.exists(backbone_weights):
        raise ModuleNotFoundError(
            f"LPIPS requires pretrained {net_type} backbone weights (torchvision-format state_dict), but no"
            f" weights file is available (no network egress for the torchvision download the reference relies"
            f" on). Set `backbone_weights` or METRICS_TPU_LPIPS_{net_type.upper()}_WEIGHTS."
        )
    if not linear_weights or not os.path.exists(linear_weights):
        raise ModuleNotFoundError(
            "LPIPS requires the learned lin-head weights (lpips-format .pth, e.g. the reference's vendored"
            " functional/image/lpips_models/*.pth). Set `linear_weights` or METRICS_TPU_LPIPS_LINEAR_WEIGHTS."
        )
    return _load_lpips_cached(net_type, backbone_weights, linear_weights, _resolve_device(device))
