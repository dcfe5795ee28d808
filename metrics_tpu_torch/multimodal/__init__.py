"""Multimodal metrics (counterpart of ``metrics_tpu/multimodal/__init__.py``)."""
from metrics_tpu_torch.multimodal.clip_score import CLIPScore

__all__ = ["CLIPScore"]
