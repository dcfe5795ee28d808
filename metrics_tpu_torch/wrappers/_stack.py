"""Stacked base states: one state dict of ``(N, *state)`` tensors for N copies of a base
metric, and the base's pure tier run over it under ``torch.func.vmap``.

Counterpart of the ``jax.tree_util.tree_map`` broadcasts and ``jax.vmap`` calls of
``metrics_tpu/wrappers/bootstrapping.py`` and ``multioutput.py``. A ``CatBuffer``
state stacks its ``data`` to ``(N, capacity, *item)``; its count and overflow flag
stay host values shared by the stack, which holds because every copy appends the same
number of rows (a resample or an output column has the batch's static length): the
stack is a :class:`StackedCatBuffer`.
"""
from typing import Any, Callable, Dict, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.state import CatBuffer

#: a CatBuffer state's shared host fields: (count, overflow)
Shared = Dict[str, Tuple[int, bool]]


class StackedCatBuffer(CatBuffer):
    """``N`` buffers that share one count and one overflow flag: ``data (N, capacity,
    *item)``. ``values()`` gives every copy's valid rows, ``(N, count, *item)``."""

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    def values(self) -> Tensor:
        return self.data[:, : self.valid_count()]

    def clone(self) -> "StackedCatBuffer":
        return StackedCatBuffer(self.data.clone(), self._count, self._overflow)

    def copy(self) -> "StackedCatBuffer":
        return StackedCatBuffer(self.data, self._count, self._overflow)

    def apply(self, fn: Any) -> "StackedCatBuffer":
        return StackedCatBuffer(fn(self.data), self._count, self._overflow)

    def __repr__(self) -> str:
        return (f"StackedCatBuffer(copies={self.data.shape[0]}, capacity={self.capacity},"
                f" item={tuple(self.data.shape[2:])}, dtype={self.data.dtype})")


def check_static(wrapper: str, base_state: Dict[str, Any]) -> None:
    """The JAX message for a base with list states, which have no static shape."""
    if any(isinstance(v, list) for v in base_state.values()):
        raise ValueError(
            f"{wrapper}'s pure tier needs static-shape base states; construct the"
            " base metric with `cat_capacity` so its cat states become CatBuffers"
        )


def stack_state(base_state: Dict[str, Any], n: int) -> Dict[str, Any]:
    """``n`` copies of a base state dict: tensors ``(n, *state)``, buffers ``(n, capacity, *item)``."""

    def stack(x: Tensor) -> Tensor:
        return x.unsqueeze(0).repeat(n, *([1] * x.dim()))

    return {
        name: StackedCatBuffer(stack(v.data), v._count, v._overflow) if isinstance(v, CatBuffer) else stack(v)
        for name, v in base_state.items()
    }


def split(state: Dict[str, Any]) -> Tuple[Dict[str, Tensor], Shared]:
    """The tensors that ``vmap`` maps over (a buffer's ``data``) and the buffers' host fields."""
    tensors = {name: v.data if isinstance(v, CatBuffer) else v for name, v in state.items()}
    shared = {name: (v._count, v._overflow) for name, v in state.items() if isinstance(v, CatBuffer)}
    return tensors, shared


def join(tensors: Dict[str, Tensor], shared: Shared, buffer: type = CatBuffer) -> Dict[str, Any]:
    """The inverse of :func:`split`: one copy's buffers inside ``vmap``, the stack's
    (``buffer=StackedCatBuffer``) outside it."""
    return {name: buffer(t, *shared[name]) if name in shared else t for name, t in tensors.items()}


def vmap_local_update(base: Any, state: Dict[str, Any], one_inputs: Callable, batched: Any) -> Dict[str, Any]:
    """``base.local_update`` of every copy in one ``vmap``: copy ``i`` updates its row
    of ``state`` with the inputs ``one_inputs(batched_i)`` returns as ``(args, kwargs)``,
    ``batched`` being mapped over its leading axis."""
    tensors, shared = split(state)
    after: Shared = {}

    def one(row: Dict[str, Tensor], b: Any) -> Dict[str, Tensor]:
        args, kwargs = one_inputs(b)
        new, fields = split(base.local_update(join(row, shared), *args, **kwargs))
        after.update(fields)  # the same for every copy: the appends have one static length
        return new

    return join(torch.func.vmap(one)(tensors, batched), after, StackedCatBuffer)


def vmap_compute(base: Any, state: Dict[str, Any]) -> Any:
    """``base.compute_from`` of every copy in one ``vmap``, stacked on a leading axis."""
    tensors, shared = split(state)
    return torch.func.vmap(lambda row: torch.as_tensor(base.compute_from(join(row, shared))))(tensors)
