"""Multimodal functionals (counterpart of ``metrics_tpu/functional/multimodal/__init__.py``)."""
from metrics_tpu_torch.functional.multimodal.clip_score import clip_score

__all__ = ["clip_score"]
