"""Input validation helpers (counterpart of ``metrics_tpu/utils/checks.py``).

The data-dependent checks read values through ``torch.unique`` or a reduction and
so synchronise with the device. As in the JAX package, they run on concrete values
only: :func:`_is_concrete` is False while a CUDA graph is being captured, inside a
``torch.func`` transform (the fleet's ``vmap``) and inside :func:`tracing` (the
engines' chained pure steps, which run eagerly on the CPU), and the checks are then
skipped. Shape and dtype checks read no data and always run.
"""
import threading
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import torch
from torch import Tensor

_TRACE = threading.local()


@contextmanager
def tracing() -> Iterator[None]:
    """Run the body as a traced step: :func:`_is_concrete` is False inside it, on
    this thread. The engines wrap their pure steps in it, so that a step skips the
    same value checks on the CPU as its captured CUDA graph does on the card."""
    _TRACE.depth = getattr(_TRACE, "depth", 0) + 1
    try:
        yield
    finally:
        _TRACE.depth -= 1


def _is_concrete(*tensors: Tensor) -> bool:
    """True iff the values of ``tensors`` may be read on the host now: no CUDA
    stream is capturing, no ``torch.func`` transform is active (and no argument is
    a batched tensor), and no :func:`tracing` step is running.

    Counterpart of ``metrics_tpu/utils/checks.py:_is_concrete``, which is False for
    jit/vmap tracers.
    """
    if getattr(_TRACE, "depth", 0):
        return False
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return False
    if torch._C._are_functorch_transforms_active():
        return False
    return not any(isinstance(t, Tensor) and torch._C._functorch.is_batchedtensor(t) for t in tensors)


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Validate ``(preds, target)`` of a single-query retrieval functional."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.dim() == 0 or preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(
        preds, target, allow_non_binary_target=allow_non_binary_target
    )


def _check_retrieval_inputs(
    indexes: Tensor,
    preds: Tensor,
    target: Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate ``(indexes, preds, target)`` of a retrieval metric's update.

    Returns flat int32 ``indexes``, float32 ``preds`` and int32 (float32 for graded
    relevance) ``target``. Negative ids are refused: -1 marks the unused rows of a
    ``CatBuffer`` state. ``ignore_index`` drops the rows whose target equals it.

    With ``validate_args`` the value checks read one flag from the device (one host
    sync per call); ``ignore_index`` filtering has a data-dependent length and syncs
    too. Without either, the call queues its work and returns.
    """
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.dim() == 0 or indexes.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
    if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a tensor of integers")
    bad_index = (indexes < 0).any() if validate_args else None
    if ignore_index is not None:
        keep = target != ignore_index
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    if validate_args:
        bad_target = torch.zeros_like(bad_index) if allow_non_binary_target else _non_binary(target)
        bad_index, bad_target = torch.stack([bad_index, bad_target]).tolist()
        if bad_index:
            raise ValueError("`indexes` must be non-negative: negative ids are reserved for buffer padding")
    _check_target_dtype(target, allow_non_binary_target)
    if validate_args and bad_target:
        raise ValueError("`target` must contain `binary` values")
    return indexes.reshape(-1).to(torch.int32), preds.reshape(-1).to(torch.float32), _as_target(target).reshape(-1)


def _check_target_dtype(target: Tensor, allow_non_binary_target: bool) -> None:
    if target.is_floating_point():
        if not allow_non_binary_target:
            raise ValueError("`target` must be a tensor of booleans or integers")
    elif target.is_complex():
        raise ValueError("`target` must be a tensor of booleans or integers")


def _non_binary(target: Tensor) -> Tensor:
    return ((target > 1) | (target < 0)).any()


def _as_target(target: Tensor) -> Tensor:
    return target.to(torch.float32) if target.is_floating_point() else target.to(torch.int32)


def _check_retrieval_target_and_prediction_types(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Target dtype (bool or integer; float too with ``allow_non_binary_target``) and
    binary values; flat float32 ``preds`` and the target as int32 (float32 when it
    is a float)."""
    _check_target_dtype(target, allow_non_binary_target)
    if not allow_non_binary_target and bool(_non_binary(target)):
        raise ValueError("`target` must contain `binary` values")
    return preds.reshape(-1).to(torch.float32), _as_target(target).reshape(-1)


def _as_float(x: Tensor) -> Tensor:
    """A float tensor that keeps a floating input's dtype (bf16, f16, f32, f64); any
    other input becomes float32, as ``metrics_tpu/utils/checks.py:_as_float``."""
    return x if x.is_floating_point() else x.to(torch.float32)
