"""Perplexity (counterpart of ``metrics_tpu/functional/text/perplexity.py``).

On the device, in plain PyTorch: the logits cast to float32, ``log_softmax`` over
the vocabulary, the target's log-probability gathered, and a masked sum, as the JAX
package's one XLA program does. No Pallas kernel backs it there, so none backs it
here. Differentiable through autograd. The ignore mask is branchless, so an update
reads nothing on the host and can be captured in a CUDA graph.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_tensor


def _perplexity_validate(preds: Tensor, target: Tensor) -> None:
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(f"Input tensor `preds` is expected to be of floating dtype but got {_dtype_name(preds)}.")
    if preds.is_complex() or target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer dtype but got {_dtype_name(target)}.")


def _dtype_name(x: Tensor) -> str:
    """The dtype as numpy names it (``float32``, ``int64``), as in the JAX package's messages."""
    return str(x.dtype).replace("torch.", "")


def _perplexity_update(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Tuple[Tensor, Tensor]:
    """The summed negative log-likelihood of the counted tokens (float32) and their
    count (int64)."""
    if validate_args:
        _perplexity_validate(preds, target)
    logits = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    target = target.reshape(-1).to(torch.int64)

    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.where(mask, target, 0)
    else:
        mask = torch.ones_like(target, dtype=torch.bool)

    log_probs = torch.log_softmax(logits, dim=-1)
    token_nll = -torch.gather(log_probs, 1, target[:, None])[:, 0]
    total_log_probs = torch.sum(torch.where(mask, token_nll, 0.0))
    count = torch.sum(mask)
    return total_log_probs, count


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds, target, ignore_index: Optional[int] = None, device=None) -> Tensor:
    """Perplexity of a language model: ``exp(mean NLL)`` over the tokens not ignored.

    Args:
        preds: logits ``[batch_size, seq_len, vocab_size]`` (normalised here).
        target: token ids ``[batch_size, seq_len]``.
        ignore_index: a target id that does not count.
        device: where array-likes that are not tensors go (``cuda`` unless named).
    """
    preds = to_tensor(preds, device)
    target = to_tensor(target, preds.device)
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
