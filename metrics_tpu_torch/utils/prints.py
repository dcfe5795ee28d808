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


def _root_class_shim(cls: type, name: str, domain: str, module: str) -> type:
    """A subclass of ``cls`` whose ``__init__`` warns (``FutureWarning``) that a domain
    metric built from the package root moved to its subpackage.

    ``module`` is the ``__name__`` of the defining ``_deprecated`` module, which binds
    the shim as ``_<name>`` so that pickled instances load again.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        warnings.warn(
            f"Importing `{name}` from `metrics_tpu_torch` was deprecated and will be removed in 2.0."
            f" Import `{name}` from `metrics_tpu_torch.{domain}` instead.",
            FutureWarning,
            stacklevel=2,
        )
        cls.__init__(self, *args, **kwargs)

    shim = type(f"_{name}", (cls,), {"__init__": __init__, "__module__": module, "__doc__": cls.__doc__})
    shim.__qualname__ = f"_{name}"
    return shim


def _root_func_shim(fn: Callable, name: str, domain: str) -> Callable:
    """``fn`` wrapped to warn (``FutureWarning``) on the root-functional call path."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        warnings.warn(
            f"Importing `{name}` from `metrics_tpu_torch.functional` was deprecated and will be removed in 2.0."
            f" Import `{name}` from `metrics_tpu_torch.functional.{domain}` instead.",
            FutureWarning,
            stacklevel=2,
        )
        return fn(*args, **kwargs)

    return wrapped
