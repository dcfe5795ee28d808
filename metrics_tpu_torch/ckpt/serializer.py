"""Payload (de)serialization: raw-byte blobs with an index in the manifest
(counterpart of ``metrics_tpu/ckpt/serializer.py``, byte-compatible with it).

- **Format.** Each entry's bytes are written back to back, C order, no padding;
  the index gives its ``offset``, ``nbytes``, ``dtype`` (numpy's name), ``shape``
  and ``crc32``. A truncated or bit-rotted payload fails restore with
  :class:`~metrics_tpu_torch.ckpt.errors.CorruptCheckpointError`.
- **bfloat16** is written as its raw 16-bit pattern under the name ``bfloat16``,
  bit-identical to what the JAX package writes through ``ml_dtypes``, and read back
  the same way; no ``ml_dtypes`` is needed.
- **Snapshots.** Torch states are mutable: ``update`` accumulates in place and a
  captured step's replay overwrites its buffers. So a snapshot taken for a write on
  another thread (``copy=True``) clones every tensor on the current stream at the
  call, and the writer waits for those clones (a CUDA event) before it moves them
  to the host. A blocking save reads the live tensors directly.

Key syntax inside a payload:

- ``tp``: array state of the root metric
- ``x@data`` / ``x@count`` / ``x@overflow``: the three fields of a ``CatBuffer``
- ``y#3``: item 3 of a list (``cat``) state
- ``metrics[2]/tp``: state of a child metric held in a list attribute
- ``AccName/tp``: state of a named collection member (prefix added by the manager)
"""
import os
import zlib
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ckpt.errors import CorruptCheckpointError
from metrics_tpu_torch.ckpt.manifest import child_metrics, dtype_name

BFLOAT16 = "bfloat16"


class HostValue(NamedTuple):
    """An entry already moved to the host: its bytes as a numpy array and the
    dtype name to record (``bfloat16`` travels as a 16-bit integer array)."""

    array: np.ndarray
    dtype: str


def snapshot_state(
    metric: Any, prefix: str = "", persistent_only: bool = False, copy: bool = False
) -> List[Tuple[str, Any, bool]]:
    """The metric tree's live state as ``(key, value, is_cat)`` entries.

    Values are the live tensors, or clones of them with ``copy`` (see the module
    docstring); a ``CatBuffer``'s count and flag are host values already. ``is_cat``
    marks cat entries (``CatBuffer`` fields, list items): the per-host shards of a
    multi-host save; array states are the replicated part.
    """
    from metrics_tpu_torch.core.state import CatBuffer

    def take(t: Any) -> Any:
        return t.detach().clone() if copy and isinstance(t, torch.Tensor) else t

    out: List[Tuple[str, Any, bool]] = []
    for name in metric._defaults:
        if persistent_only and not metric._persistent.get(name, False):
            continue
        value = getattr(metric, name)
        if isinstance(value, CatBuffer):
            out.append((f"{prefix}{name}@data", take(value.data), True))
            out.append((f"{prefix}{name}@count", np.asarray(value._count, np.int32), True))
            out.append((f"{prefix}{name}@overflow", np.asarray(value._overflow, np.bool_), True))
        elif isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                out.append((f"{prefix}{name}#{i}", take(item), True))
        else:
            out.append((f"{prefix}{name}", take(value), False))
    for attr, child in child_metrics(metric).items():
        if isinstance(child, list):
            for i, c in enumerate(child):
                out.extend(snapshot_state(c, f"{prefix}{attr}[{i}]/", persistent_only, copy))
        else:
            out.extend(snapshot_state(child, f"{prefix}{attr}/", persistent_only, copy))
    return out


def to_host(value: Any) -> Tuple[np.ndarray, str]:
    """``(C-contiguous numpy array, dtype name)`` of one entry; a bfloat16 tensor
    comes back as its raw 16-bit pattern under the name ``bfloat16``."""
    if isinstance(value, HostValue):
        return value.array, value.dtype
    if isinstance(value, torch.Tensor):
        t = value.detach()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return np.require(t.cpu().numpy(), requirements="C"), name
    arr = np.require(np.asarray(value), requirements="C")
    return arr, str(arr.dtype)


def write_payload(path: str, entries: List[Tuple[str, Any, bool]]) -> Dict[str, Any]:
    """Write the entries as one raw blob at ``path``; returns the payload index.

    The device-to-host copy happens here (on the writer thread of an async save).
    The file is fsynced before returning, so a manifest never points at bytes that
    are not on disk.
    """
    index: Dict[str, Dict[str, Any]] = {}
    offset = 0
    with open(path, "wb") as fh:
        for key, value, _ in entries:
            arr, name = to_host(value)
            raw = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else memoryview(b"")
            index[key] = {
                "offset": offset,
                "nbytes": raw.nbytes,
                "dtype": name,
                "shape": list(arr.shape),
                "crc32": zlib.crc32(raw),
            }
            fh.write(raw)
            offset += raw.nbytes
        fh.flush()
        os.fsync(fh.fileno())
    return {"file": os.path.basename(path), "nbytes": offset, "index": index}


def _decode(blob: bytearray, start: int, n: int, name: str, shape: List[int]) -> torch.Tensor:
    """One entry of ``blob`` as a CPU tensor (a view of the blob where aligned)."""
    try:
        dtype = np.dtype(np.int16 if name == BFLOAT16 else name)
    except TypeError as err:
        raise CorruptCheckpointError(f"checkpoint entry has unknown dtype {name!r}") from err
    if n % dtype.itemsize:
        raise CorruptCheckpointError(f"checkpoint entry of {n} bytes is not a whole number of {name} items")
    if n == 0:
        arr = np.zeros(shape, dtype)
    else:
        arr = np.frombuffer(blob, dtype=dtype, count=n // dtype.itemsize, offset=start)
        if not arr.flags.aligned:
            arr = arr.copy()
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(torch.bfloat16) if name == BFLOAT16 else t


def load_payload(path: str, payload_meta: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Read a payload blob back into ``{key: CPU tensor}``, checking every entry's
    length and CRC32."""
    try:
        size = os.path.getsize(path)
        blob = bytearray(size)
        with open(path, "rb") as fh:
            got = fh.readinto(blob)
        del blob[got:]
    except OSError as err:
        raise CorruptCheckpointError(f"cannot read checkpoint payload {path}: {err}") from err
    if len(blob) < int(payload_meta.get("nbytes", 0)):
        raise CorruptCheckpointError(
            f"truncated checkpoint payload {path}: {len(blob)} bytes on disk,"
            f" manifest promises {payload_meta['nbytes']}"
        )
    view = memoryview(blob)
    out: Dict[str, torch.Tensor] = {}
    for key, meta in payload_meta["index"].items():
        start, n = int(meta["offset"]), int(meta["nbytes"])
        if start + n > len(blob):
            raise CorruptCheckpointError(
                f"truncated checkpoint payload {path}: entry `{key}` ends at {start + n}, file has {len(blob)} bytes"
            )
        if zlib.crc32(view[start:start + n]) != int(meta["crc32"]):
            raise CorruptCheckpointError(f"checksum mismatch for entry `{key}` in {path}")
        out[key] = _decode(blob, start, n, meta["dtype"], meta["shape"])
    return out


def iter_list_items(payload: Dict[str, torch.Tensor], prefix: str, name: str) -> Iterator[torch.Tensor]:
    """The ``{prefix}{name}#i`` items of one list state, in index order."""
    i = 0
    while f"{prefix}{name}#{i}" in payload:
        yield payload[f"{prefix}{name}#{i}"]
        i += 1
