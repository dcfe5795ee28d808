"""CLIPScore (counterpart of ``metrics_tpu/functional/multimodal/clip_score.py``).

The encoders are a pair of callables

    ``image_encoder(images [N, C, H, W]) -> (N, D)`` features,
    ``text_encoder(captions: Sequence[str]) -> (N, D)`` features

(unnormalised; the L2 normalisation happens here).
:func:`metrics_tpu_torch.models.clip.torch_clip_encoders` builds both from a local
checkpoint; with ``transformers`` installed and the weights of
``model_name_or_path`` cached, a default pair runs the HF model on ``device``. The
score is ``mean(max(100 * cos(E_I, E_C), 0))``, on the image features' device.
"""
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device, to_tensor
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE

_DEFAULT_CLIP = "openai/clip-vit-large-patch14"

ImageEncoder = Callable[[Tensor], Tensor]
TextEncoder = Callable[[Sequence[str]], Tensor]


def _default_clip_encoders(model_name_or_path: str, device=None) -> Tuple[ImageEncoder, TextEncoder]:
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`clip_score` with `model_name_or_path` requires the `transformers` package. Either install it or "
            "pass `image_encoder` and `text_encoder` callables."
        )
    device = _resolve_device(device)
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(model_name_or_path)
    processor = CLIPProcessor.from_pretrained(model_name_or_path)
    model.eval()
    model.to(device)

    def image_encoder(images: Tensor) -> Tensor:
        batch = processor(images=[i.cpu().numpy() for i in images], return_tensors="pt")
        with torch.no_grad(), fp32_exact():
            return model.get_image_features(batch["pixel_values"].to(device))

    def text_encoder(captions: Sequence[str]) -> Tensor:
        batch = processor(text=list(captions), return_tensors="pt", padding=True)
        with torch.no_grad(), fp32_exact():
            return model.get_text_features(batch["input_ids"].to(device), batch["attention_mask"].to(device))

    return image_encoder, text_encoder


def _clip_score_from_features(img_features: Tensor, txt_features: Tensor) -> Tensor:
    """Per-sample ``100 * cos`` similarity."""
    img = img_features / torch.clamp(torch.linalg.vector_norm(img_features, dim=-1, keepdim=True), min=1e-30)
    txt = txt_features / torch.clamp(torch.linalg.vector_norm(txt_features, dim=-1, keepdim=True), min=1e-30)
    return 100.0 * torch.sum(img * txt, dim=-1)


def _clip_score_update(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, Sequence[str]],
    image_encoder: ImageEncoder,
    text_encoder: TextEncoder,
    device=None,
) -> Tuple[Tensor, int]:
    if isinstance(images, (list, tuple)):
        if not all(i.ndim == 3 for i in images):
            raise ValueError("Expected all images to be 3d but found image that has either more or less")
        images = torch.stack([to_tensor(i, device) for i in images])
    else:
        images = to_tensor(images, device)
        if images.ndim == 3:
            images = images[None]
    text_l = [text] if isinstance(text, str) else list(text)
    if len(text_l) != images.shape[0]:
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {images.shape[0]}"
            f" and {len(text_l)}"
        )
    img_features = to_tensor(image_encoder(images), images.device).to(torch.float32)
    txt_features = to_tensor(text_encoder(text_l), img_features.device).to(torch.float32)
    return _clip_score_from_features(img_features, txt_features), len(text_l)


def clip_score(
    images: Union[Tensor, List[Tensor]],
    text: Union[str, Sequence[str]],
    model_name_or_path: str = _DEFAULT_CLIP,
    image_encoder: Optional[ImageEncoder] = None,
    text_encoder: Optional[TextEncoder] = None,
    device=None,
) -> Tensor:
    """CLIPScore text-image alignment: ``mean(max(100 * cos(E_I, E_C), 0))``.

    Args:
        images: ``(N, C, H, W)`` tensor or list of ``(C, H, W)`` tensors; arrays that
            are not tensors go to ``device``.
        text: caption(s), one per image.
        model_name_or_path: HF CLIP checkpoint of the default encoders.
        image_encoder / text_encoder: custom feature callables (both or neither).
        device: where the default encoders run and where non-tensor images go;
            ``cuda`` by default.
    """
    if (image_encoder is None) != (text_encoder is None):
        raise ValueError("`image_encoder` and `text_encoder` must be provided together.")
    if image_encoder is None:
        image_encoder, text_encoder = _default_clip_encoders(model_name_or_path, device)
    score, _ = _clip_score_update(images, text, image_encoder, text_encoder, device)
    score = score.mean(0)
    return torch.clamp(score, min=0.0)
