"""Rank-zero-only warnings and prints (counterpart of ``metrics_tpu/utils/prints.py``).

The rank is ``torch.distributed``'s when a process group is initialised, else 0.
"""
import warnings
from functools import wraps
from typing import Any, Callable

import torch


def _rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    warnings.warn(message, *args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    print(*args, **kwargs)
