"""Fixed-capacity cat states (counterpart of ``metrics_tpu/core/state.py``).

A ``cat`` state is by default a growing list of tensors, concatenated at
``compute``. With ``cat_capacity`` set, a metric keeps it instead as one
preallocated ``(capacity, *item_shape)`` buffer plus a count: an ``append`` copies
the new rows in place at the count, and ``compute`` reads the valid rows as one
view, with nothing to concatenate.

The semantics are the JAX package's: ``count`` is the true number of appended
rows, also past capacity; on overflow the newest append overwrites the tail rows
(it writes at ``clip(count, 0, capacity - n)``); the ``overflow`` flag is sticky;
``values()`` warns when rows were lost.

The count follows from the appended shapes, so the buffer keeps it (and the flag)
as host integers: ``append``, ``valid_count`` and ``overflowed`` never wait for the
card. ``count`` and ``overflow`` also read as 0-d tensors on the buffer's device,
the form of the JAX package's state dict.

:func:`cat_sync` gathers a buffer from every rank of a process group into one of
``world * capacity`` rows, the valid rows first. :meth:`CatBuffer.from_rows` packs
restored rows into a fresh buffer when a checkpoint restores onto another capacity or
host count (:mod:`~metrics_tpu_torch.ckpt.restore`).
"""
from typing import Any, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn


class CatBuffer:
    """Fixed-capacity append buffer: ``data (capacity, *item)``, a true count and a
    sticky overflow flag."""

    def __init__(self, data: Tensor, count: Union[int, Tensor] = 0, overflow: Union[bool, Tensor] = False) -> None:
        self.data = data
        self._count = int(count)
        self._overflow = bool(overflow)

    @classmethod
    def create(
        cls,
        capacity: int,
        item_shape: Sequence[int] = (),
        dtype: torch.dtype = torch.float32,
        fill_value: Union[int, float] = 0,
        device: Union[str, torch.device, None] = None,
    ) -> "CatBuffer":
        return cls(torch.full((capacity, *item_shape), fill_value, dtype=dtype, device=device))

    # ----------------------------------------------------------- accessors
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def count(self) -> Tensor:
        """The true append count as a 0-d int32 tensor on the buffer's device."""
        return torch.tensor(self._count, dtype=torch.int32, device=self.data.device)

    @property
    def overflow(self) -> Tensor:
        """The sticky overflow flag as a 0-d bool tensor on the buffer's device."""
        return torch.tensor(self._overflow, dtype=torch.bool, device=self.data.device)

    def valid_count(self) -> int:
        return min(self._count, self.capacity)

    def overflowed(self) -> bool:
        """Rows were lost: more appended than fit, or an overflowed state merged in."""
        return self._overflow or self._count > self.capacity

    def mask(self) -> Tensor:
        """Boolean validity mask over the capacity axis."""
        return torch.arange(self.capacity, device=self.data.device) < self.valid_count()

    def values(self) -> Tensor:
        """The valid rows, as a view of the buffer; warns if rows were lost."""
        if self.overflowed():
            rank_zero_warn(
                f"CatBuffer overflow: {self._count} elements were appended into capacity {self.capacity}"
                " (or an overflowed device state was synced in); the newest appends overwrote"
                " the tail. Increase `cat_capacity`.",
                RuntimeWarning,
            )
        return self.data[: self.valid_count()]

    def clone(self) -> "CatBuffer":
        """A buffer of its own: appends to one do not show in the other."""
        return CatBuffer(self.data.clone(), self._count, self._overflow)

    def copy(self) -> "CatBuffer":
        """A new buffer object over the same data (the JAX package's ``copy``): its
        count and flag are its own, its appends write into the shared rows."""
        return CatBuffer(self.data, self._count, self._overflow)

    def apply(self, fn: Any) -> "CatBuffer":
        """The buffer with ``fn`` applied to its data (``Module._apply``: ``.to``, ``.cuda``)."""
        return CatBuffer(fn(self.data), self._count, self._overflow)

    def to_host(self) -> dict:
        """The three fields as host values, ``count`` the true append count."""
        return {"data": self.data.cpu().numpy(), "count": self._count, "overflow": self._overflow}

    @classmethod
    def from_rows(
        cls,
        rows: Any,
        capacity: int,
        fill_value: Union[int, float] = 0,
        dtype: Any = None,
        overflow: bool = False,
        device: Union[str, torch.device, None] = None,
    ) -> "CatBuffer":
        """Dense valid rows packed into a fresh buffer of ``capacity``; more rows raise."""
        rows = torch.as_tensor(np.asarray(rows) if not isinstance(rows, Tensor) else rows)
        if dtype is not None:
            rows = rows.to(dtype)
        if rows.shape[0] > capacity:
            raise ValueError(f"{rows.shape[0]} rows do not fit capacity {capacity}")
        data = torch.full((capacity, *rows.shape[1:]), fill_value, dtype=rows.dtype, device=device)
        data[: rows.shape[0]] = rows.to(data.device)
        return cls(data, rows.shape[0], overflow)

    def __len__(self) -> int:
        return self.valid_count()

    def __repr__(self) -> str:
        return f"CatBuffer(capacity={self.capacity}, item={tuple(self.data.shape[1:])}, dtype={self.data.dtype})"

    # ------------------------------------------------------------ mutation
    def append(self, values: Tensor) -> "CatBuffer":
        """Copy rows in at the count, in place; returns self. No host sync."""
        values = torch.as_tensor(values)
        if values.dim() == self.data.dim() - 1:
            values = values.unsqueeze(0)
        values = values.to(device=self.data.device, dtype=self.data.dtype)
        n_true = values.shape[0]  # the count keeps the true total so overflow shows
        if n_true > self.capacity:
            values = values[: self.capacity]
        n = values.shape[0]
        start = min(max(self._count, 0), self.capacity - n)
        self.data[start:start + n] = values
        self._count += n_true
        return self

    def extend(self, value_list) -> "CatBuffer":
        for v in value_list:
            self.append(v)
        return self


def cat_sync(buf: CatBuffer, group: Any) -> CatBuffer:
    """``buf`` gathered from every rank of the process ``group``, the valid rows
    packed to the front in rank order (the JAX package's stable front-pack).

    Every rank's buffer has the same capacity; the result has ``world * capacity``
    rows, a count of the valid rows in all, and the overflow flag OR-ed across the
    ranks. Each rank's valid count and flag travel with one small gather and are read
    on the host once (the buffer keeps its count there).
    """
    from metrics_tpu_torch.parallel.collective import pad_gather

    header = torch.tensor([buf.valid_count(), int(buf.overflowed())], dtype=torch.int64, device=buf.device)
    data, headers = pad_gather(buf.data, header, group)
    counts, flags = headers.reshape(-1, 2).t().tolist()
    capacity = buf.capacity
    valid = [data[r * capacity:r * capacity + c] for r, c in enumerate(counts)]
    unused = [data[r * capacity + c:(r + 1) * capacity] for r, c in enumerate(counts)]
    return CatBuffer(torch.cat(valid + unused, dim=0), sum(counts), any(flags))


def cat_merge(global_buf: CatBuffer, local_buf: CatBuffer) -> CatBuffer:
    """Merge for ``forward``'s reduce-state mode: a new buffer, global's rows then local's."""
    merged = global_buf.clone()
    merged.append(local_buf.values())
    merged._overflow = merged._overflow or local_buf.overflowed()
    return merged


def is_cat_buffer(x: Any) -> bool:
    return isinstance(x, CatBuffer)


def cat_values(x: Union[CatBuffer, list, tuple, Tensor, np.ndarray]) -> Tensor:
    """Dense concatenated view of any cat-state representation."""
    if isinstance(x, CatBuffer):
        return x.values()
    if isinstance(x, (list, tuple)):
        return torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in x], dim=0)
    return torch.as_tensor(x)
