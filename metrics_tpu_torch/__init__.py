"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu, for NVIDIA Hopper.

Same public names and state contract as ``metrics_tpu``; entry points run on the
card (``cuda``) unless the caller asks for another device. Kernels written by hand
live under ``csrc/`` and build at first use into ``build/kernels/``.
"""
from metrics_tpu_torch.core.metric import Metric

__all__ = ["Metric"]
