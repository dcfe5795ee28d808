"""A fixed-capacity ring buffer (counterpart of ``metrics_tpu/obs/ring.py``).

The ingest queue (:mod:`metrics_tpu_torch.serve.ingest`) stages its pending
batches here; the flight recorder of the observability slice will append its
events to the same ring. Three properties:

- **Fixed capacity**: the backing ``collections.deque`` is sized at construction;
  a full ring either evicts the oldest item (:meth:`append`) or refuses the new
  one (:meth:`try_append`, the ingest queue's backpressure decides what follows).
- **Lock-free evicting append**: ``deque.append`` with ``maxlen`` is atomic under
  the GIL, so a hot-path producer never takes a lock.
- **Drain under a lock**: consumers that must neither lose nor see an item twice
  (:meth:`drain`, :meth:`pop_oldest`, :meth:`try_append`) take one internal lock;
  :meth:`snapshot` instead retries the rare ``RuntimeError`` of iterating while an
  append runs.
"""
import threading
from collections import deque
from typing import Any, List, Optional

__all__ = ["Ring"]


class Ring:
    """Bounded FIFO ring: lock-free evicting append, locked exact drain."""

    __slots__ = ("_dq", "_capacity", "_lock")

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self._capacity = int(capacity)
        self._dq: deque = deque(maxlen=self._capacity)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return len(self._dq)

    @property
    def full(self) -> bool:
        return len(self._dq) >= self._capacity

    def append(self, item: Any) -> None:
        """Lock-free append; evicts the oldest item when full."""
        self._dq.append(item)

    def try_append(self, item: Any) -> bool:
        """Append under the lock, refusing (False) instead of evicting, so that
        concurrent producers never overshoot the capacity."""
        with self._lock:
            if len(self._dq) >= self._capacity:
                return False
            self._dq.append(item)
            return True

    def pop_oldest(self) -> Optional[Any]:
        """Remove and return the oldest item, or None when empty (locked)."""
        with self._lock:
            try:
                return self._dq.popleft()
            except IndexError:
                return None

    def drain(self, limit: Optional[int] = None) -> List[Any]:
        """Remove and return up to ``limit`` oldest items (all, when None), under
        the lock: every item lands in exactly one drain."""
        out: List[Any] = []
        with self._lock:
            n = len(self._dq) if limit is None else min(limit, len(self._dq))
            for _ in range(n):
                out.append(self._dq.popleft())
        return out

    def snapshot(self) -> List[Any]:
        """Copy of the items, oldest first, without locking out the producer."""
        for _ in range(8):
            try:
                return list(self._dq)
            except RuntimeError:
                continue
        return list(self._dq)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()
