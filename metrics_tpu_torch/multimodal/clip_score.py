"""CLIPScore (counterpart of ``metrics_tpu/multimodal/clip_score.py``): a float32 sum of
the per-sample scores and an int64 count (the JAX package's is int32)."""
from typing import Any, List, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.multimodal.clip_score import (
    _DEFAULT_CLIP,
    ImageEncoder,
    TextEncoder,
    _clip_score_update,
    _default_clip_encoders,
)


class CLIPScore(Metric):
    """Running-mean CLIPScore: ``max(100 * cos(E_I, E_C), 0)`` over all samples.

    Args:
        model_name_or_path: HF CLIP checkpoint of the default ``transformers``
            encoders, built on the metric's device at the first update (needs
            locally cached weights).
        image_encoder / text_encoder: custom feature callables (both or neither); see
            :mod:`metrics_tpu_torch.functional.multimodal.clip_score`. Build both on
            the card with :func:`metrics_tpu_torch.models.clip.torch_clip_encoders`.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    # captions are strings: update checks the images' device itself
    _host_side_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(
        self,
        model_name_or_path: str = _DEFAULT_CLIP,
        image_encoder: Optional[ImageEncoder] = None,
        text_encoder: Optional[TextEncoder] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if (image_encoder is None) != (text_encoder is None):
            raise ValueError("`image_encoder` and `text_encoder` must be provided together.")
        self.model_name_or_path = model_name_or_path
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.tensor(0, dtype=torch.int64), dist_reduce_fx="sum")

    def _encoders(self):
        if self.image_encoder is None:
            # build (and cache) the default encoders once
            self.image_encoder, self.text_encoder = _default_clip_encoders(self.model_name_or_path, self.device)
        return self.image_encoder, self.text_encoder

    def update(self, images: Union[Tensor, List[Tensor]], text: Union[str, Sequence[str]]) -> None:
        images = [self._check_device(i) for i in images] if isinstance(images, (list, tuple)) \
            else self._check_device(images)
        image_encoder, text_encoder = self._encoders()
        score, n_samples = _clip_score_update(images, text, image_encoder, text_encoder, self.device)
        self.score = self.score + score.sum(0)
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> Tensor:
        return torch.clamp(self.score / self.n_samples, min=0.0)
