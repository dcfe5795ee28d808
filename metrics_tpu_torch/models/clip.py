"""CLIP (ViT image tower and text transformer) for CLIPScore as ``nn.Module``s
(counterpart of ``metrics_tpu/models/clip.py``).

Pre-LN blocks with ``quick_gelu`` MLPs; the text tower attends under a causal plus
padding bias and pools at the first EOS token; the image tower embeds patches by a
``conv2d`` whose stride is its kernel. Float32 with TF32 off. The weights come from a
HF ``CLIPModel`` state dict in a local ``.npz``/``.pth`` file; nothing is downloaded.

:func:`preprocess` is the JAX package's pipeline on tensors: a bicubic resize of the
shorter side to ``size``, a center crop, a rescale to [0, 1] and the channel
normalisation. ``jax.image.resize(method="bicubic")`` is what ``F.interpolate(
mode="bicubic", align_corners=False, antialias=True)`` computes (Keys' cubic with
a = -0.5, widened when downsampling); the default ``antialias=False`` is another
kernel.
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.models._io import load_checkpoint_state
from metrics_tpu_torch.models._transformer import (
    NEG_BIAS,
    infer_num_heads,
    layer_norm,
    linear,
    multi_head_attention,
    pad_token_batch,
)
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device, to_tensor

# openai CLIP preprocessing constants (CLIPProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# the port's layer names -> the HF names under ``<tower>.encoder.layers.{i}.``
_LAYER_KEYS = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj",
    "ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}
_TOWER_KEYS = {
    "text.token_emb.weight": "text_model.embeddings.token_embedding.weight",
    "text.pos_emb.weight": "text_model.embeddings.position_embedding.weight",
    "text.final_ln.weight": "text_model.final_layer_norm.weight",
    "text.final_ln.bias": "text_model.final_layer_norm.bias",
    "text.proj.weight": "text_projection.weight",
    "vision.cls_emb": "vision_model.embeddings.class_embedding",
    "vision.patch_emb.weight": "vision_model.embeddings.patch_embedding.weight",
    "vision.pos_emb.weight": "vision_model.embeddings.position_embedding.weight",
    # sic: HF spells it `pre_layrnorm`
    "vision.pre_ln.weight": "vision_model.pre_layrnorm.weight",
    "vision.pre_ln.bias": "vision_model.pre_layrnorm.bias",
    "vision.post_ln.weight": "vision_model.post_layernorm.weight",
    "vision.post_ln.bias": "vision_model.post_layernorm.bias",
    "vision.proj.weight": "visual_projection.weight",
}


def _quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(x: Tensor, ln: nn.LayerNorm) -> Tensor:
    return layer_norm(x, ln.weight, ln.bias)


class _CLIPLayer(nn.Module):
    def __init__(self, width: int, ffn: int) -> None:
        super().__init__()
        self.q, self.k, self.v = nn.Linear(width, width), nn.Linear(width, width), nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.ln1, self.ln2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.fc1, self.fc2 = nn.Linear(width, ffn), nn.Linear(ffn, width)

    def forward(self, x: Tensor, mask_bias: Optional[Tensor], num_heads: int) -> Tensor:
        x = x + multi_head_attention(_ln(x, self.ln1), self.q, self.k, self.v, self.out, mask_bias, num_heads)
        return x + linear(_quick_gelu(linear(_ln(x, self.ln2), self.fc1)), self.fc2)


class _TextTower(nn.Module):
    def __init__(self, vocab_size: int, width: int, layers: int, ffn: int, max_positions: int, projection: int):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, width)
        self.pos_emb = nn.Embedding(max_positions, width)
        self.layers = nn.ModuleList(_CLIPLayer(width, ffn) for _ in range(layers))
        self.final_ln = nn.LayerNorm(width)
        self.proj = nn.Linear(width, projection, bias=False)


class _VisionTower(nn.Module):
    def __init__(self, width: int, layers: int, ffn: int, patch: int, image_size: int, projection: int):
        super().__init__()
        self.cls_emb = nn.Parameter(torch.zeros(width))
        self.patch_emb = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.pos_emb = nn.Embedding((image_size // patch) ** 2 + 1, width)
        self.pre_ln = nn.LayerNorm(width)
        self.layers = nn.ModuleList(_CLIPLayer(width, ffn) for _ in range(layers))
        self.post_ln = nn.LayerNorm(width)
        self.proj = nn.Linear(width, projection, bias=False)


class CLIPModel(nn.Module):
    """Both CLIP towers; the defaults are ``openai/clip-vit-large-patch14``'s shape.

    Args:
        vocab_size, text_width, text_layers, text_ffn, max_positions: the text tower.
        vision_width, vision_layers, vision_ffn, patch_size, image_size: the image tower.
        projection_dim: the width of both projections.
        text_heads / vision_heads: attention heads; 64-wide heads when None.
        device: where the weights live; ``cuda`` by default.
    """

    def __init__(
        self,
        vocab_size: int = 49408,
        text_width: int = 768,
        text_layers: int = 12,
        text_ffn: int = 3072,
        max_positions: int = 77,
        vision_width: int = 1024,
        vision_layers: int = 24,
        vision_ffn: int = 4096,
        patch_size: int = 14,
        image_size: int = 224,
        projection_dim: int = 768,
        text_heads: Optional[int] = None,
        vision_heads: Optional[int] = None,
        device=None,
    ) -> None:
        super().__init__()
        device = _resolve_device(device)
        self.text_heads = text_heads or infer_num_heads(text_width)
        self.vision_heads = vision_heads or infer_num_heads(vision_width)
        with torch.device(device):
            self.text = _TextTower(vocab_size, text_width, text_layers, text_ffn, max_positions, projection_dim)
            self.vision = _VisionTower(vision_width, vision_layers, vision_ffn, patch_size, image_size, projection_dim)
        self.requires_grad_(False)
        self.eval()

    @classmethod
    def from_state(
        cls, state: Dict[str, Any], text_heads: Optional[int] = None, vision_heads: Optional[int] = None, device=None
    ) -> "CLIPModel":
        """The model whose weights are ``state``, the port's state dict
        (:func:`params_from_state_dict` or :func:`metrics_tpu_torch.convert.clip_state_from_jax`);
        the shape is read from it."""
        state = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, Tensor) else v, dtype=torch.float32)
                 for k, v in state.items()}

        def count(tower: str) -> int:
            return sum(1 for k in state if k.startswith(f"{tower}.layers.") and k.endswith(".q.weight"))

        vocab_size, text_width = state["text.token_emb.weight"].shape
        vision_width, _, patch, _ = state["vision.patch_emb.weight"].shape
        tokens = state["vision.pos_emb.weight"].shape[0] - 1
        model = cls(
            vocab_size, text_width, count("text"), state["text.layers.0.fc1.weight"].shape[0],
            state["text.pos_emb.weight"].shape[0], vision_width, count("vision"),
            state["vision.layers.0.fc1.weight"].shape[0], patch, int(round(tokens ** 0.5)) * patch,
            state["text.proj.weight"].shape[0], text_heads, vision_heads, device="meta",
        )
        model.load_state_dict(state, assign=True)
        return model.to(_resolve_device(device)).requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.text.token_emb.weight.device

    @torch.no_grad()
    def text_features(self, input_ids: Tensor, attention_mask: Tensor, eos_token_id: int) -> Tensor:
        """Projected text features (HF CLIPTextTransformer + text_projection)."""
        p = self.text
        b, s = input_ids.shape
        with fp32_exact():
            x = p.token_emb.weight[input_ids] + p.pos_emb.weight[:s]
            idx = torch.arange(s, device=x.device)
            causal = torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_BIAS)  # (S, S)
            pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_BIAS)  # (B, 1, 1, S)
            mask_bias = (causal[None, None] + pad).to(x.dtype)
            for layer in p.layers:
                x = layer(x, mask_bias, self.text_heads)
            x = _ln(x, p.final_ln)
            eos_pos = (input_ids == eos_token_id).to(torch.int32).argmax(dim=-1)
            pooled = x[torch.arange(b, device=x.device), eos_pos]
            return linear(pooled, p.proj)

    @torch.no_grad()
    def image_features(self, pixel_values: Tensor) -> Tensor:
        """Projected image features (HF CLIPVisionTransformer + visual_projection) of
        ``pixel_values`` (B, 3, H, W), already preprocessed (see :func:`preprocess`)."""
        p = self.vision
        with fp32_exact():
            patches = p.patch_emb(pixel_values.to(torch.float32))  # (B, D, H/P, W/P)
            b, d = patches.shape[:2]
            x = patches.reshape(b, d, -1).transpose(1, 2)  # (B, N, D)
            x = torch.cat([p.cls_emb.expand(b, 1, d), x], dim=1) + p.pos_emb.weight[None]
            x = _ln(x, p.pre_ln)
            for layer in p.layers:
                x = layer(x, None, self.vision_heads)
            return linear(_ln(x[:, 0], p.post_ln), p.proj)


def _tower_layers(state: Dict[str, np.ndarray], tower: str, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    i = 0
    while f"{prefix}encoder.layers.{i}.self_attn.q_proj.weight" in state:
        for name, key in _LAYER_KEYS.items():
            for leaf in ("weight", "bias"):
                out[f"{tower}.layers.{i}.{name}.{leaf}"] = np.asarray(state[f"{prefix}encoder.layers.{i}.{key}.{leaf}"])
        i += 1
    if i == 0:
        raise ValueError(f"state_dict has no `{prefix}encoder.layers.*` keys — not a CLIP checkpoint")
    return out


def params_from_state_dict(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF ``CLIPModel`` state dict -> the port's state dict of :class:`CLIPModel`."""
    out = _tower_layers(state, "text", "text_model.")
    out.update(_tower_layers(state, "vision", "vision_model."))
    out.update({name: np.asarray(state[key]) for name, key in _TOWER_KEYS.items()})
    return out


def preprocess(images, size: int = 224, unit_range: Optional[bool] = None, device=None) -> Tensor:
    """CLIPProcessor-equivalent pipeline: bicubic resize (shorter side), center crop,
    rescale to [0, 1], channel normalisation. Input: (N, 3, H, W) or (3, H, W).

    ``unit_range`` declares float inputs' convention: ``True`` = already [0, 1],
    ``False`` = [0, 255]. With ``None``, uint8 is [0, 255] and floats are detected by
    their largest value.
    """
    raw = to_tensor(images, device)
    if unit_range is None:
        unit_range = bool(float(raw.max()) <= 1.0) if raw.is_floating_point() else False
    x = raw.to(torch.float32)
    if x.ndim == 3:
        x = x[None]
    _, _, h, w = x.shape
    scale = size / min(h, w)
    nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False, antialias=True)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top:top + size, left:left + size]
    if not unit_range:
        x = x / 255.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def clip_encoders_from_model(
    model: CLIPModel,
    tokenizer,
    image_size: int = 224,
    eos_token_id: int = 49407,
    max_length: int = 77,
    unit_range: Optional[bool] = None,
):
    """CLIPScore's ``(image_encoder, text_encoder)`` over ``model``; features land on
    the model's device."""

    def image_encoder(images) -> Tensor:
        if isinstance(images, (list, tuple)):
            images = torch.stack([to_tensor(i, model.device) for i in images])
        return model.image_features(preprocess(images, image_size, unit_range, device=model.device))

    def text_encoder(captions: Sequence[str]) -> Tensor:
        batch = tokenizer(list(captions), padding=True, truncation=True, max_length=max_length, return_tensors="np")
        # power-of-two buckets as in the JAX package, capped at the position table
        ids, mask = pad_token_batch(np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"]), 0,
                                    cap=max_length)
        ids_t, mask_t = (torch.as_tensor(a, dtype=torch.int64, device=model.device) for a in (ids, mask))
        return model.text_features(ids_t, mask_t, eos_token_id)

    return image_encoder, text_encoder


def torch_clip_encoders(
    weights_path: str,
    tokenizer,
    image_size: int = 224,
    text_heads: Optional[int] = None,
    vision_heads: Optional[int] = None,
    eos_token_id: int = 49407,
    max_length: int = 77,
    unit_range: Optional[bool] = None,
    device=None,
) -> Tuple[Any, Any]:
    """CLIPScore's ``(image_encoder, text_encoder)`` running in PyTorch on ``device``
    (counterpart of ``jax_clip_encoders``).

    Args:
        weights_path: HF ``CLIPModel`` state dict (``.bin``/``.pth``/``.npz``).
        tokenizer: HF CLIP tokenizer instance (host side).
        eos_token_id: EOS id used for text pooling (49407 for the openai vocabulary).
        device: where the towers run; ``cuda`` by default.
    """
    model = CLIPModel.from_state(params_from_state_dict(load_checkpoint_state(weights_path)), text_heads,
                                 vision_heads, device)
    return clip_encoders_from_model(model, tokenizer, image_size, eos_token_id, max_length, unit_range)
