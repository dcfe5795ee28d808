"""Input validation helpers (counterpart of ``metrics_tpu/utils/checks.py``).

PyTorch runs eagerly, so the data-dependent checks that the JAX package skips under
tracing always run here when ``validate_args`` is on; they read values through
``torch.unique`` and so synchronise with the device.
"""
from torch import Tensor


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
