"""Restore: load validated payloads into a live metric tree
(counterpart of ``metrics_tpu/ckpt/restore.py``).

Topology change (saved on N hosts, restored onto M hosts):

====================  =======================  ==================================
state kind / reduce    N == M                   N != M
====================  =======================  ==================================
array, replicated      host 0's copy            host 0's copy (all hosts)
array sum (per-host)   own shard, verbatim      re-reduced total on host 0,
                                                reset default on hosts > 0
array max/min          own shard, verbatim      element-wise merge, all hosts
array mean             own shard, verbatim      mean of means, all hosts
array None/callable    own shard, verbatim      TopologyError (not re-reducible)
cat (CatBuffer/list)   own shard, verbatim*     rows re-packed: concatenated in
                                                host order, split contiguously
                                                over the M hosts
====================  =======================  ==================================

``*`` verbatim when the live capacity equals the saved one, including the true
count past capacity and the sticky overflow flag. Otherwise the valid rows are
re-packed; the flag survives (ORed across hosts), the true count becomes the packed
row count. A re-reduced state keeps its saved dtype.

Every restored tensor is a fresh tensor on the metric's device: the fused engine
copies it into its step buffers at the next replay. Assignment is all-or-nothing
per restore call: validation runs on the whole manifest before the first
``setattr``.
"""
from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.ckpt.errors import CapacityError, CorruptCheckpointError, TopologyError
from metrics_tpu_torch.ckpt.manifest import KIND_CAT_BUFFER, KIND_LIST, child_metrics
from metrics_tpu_torch.ckpt.serializer import iter_list_items

Payload = Dict[str, torch.Tensor]


def _require(payload: Payload, key: str) -> torch.Tensor:
    try:
        return payload[key]
    except KeyError:
        raise CorruptCheckpointError(f"checkpoint payload is missing entry `{key}`") from None


def _owned(value: torch.Tensor, device: Any) -> torch.Tensor:
    """One restored leaf as a tensor of the metric's own on its device (a copy when
    it is already there: the payload's CPU tensors are views of the read blob)."""
    out = value.to(device)
    return out.clone() if out.data_ptr() == value.data_ptr() else out


def split_items(items: List[Any], world: int, rank: int) -> List[Any]:
    """Contiguous split of ``items`` into ``world`` near-equal parts; part ``rank``
    (``np.array_split``'s rule: the first ``len % world`` parts get one more)."""
    n = len(items)
    base, rem = divmod(n, world)
    start = rank * base + min(rank, rem)
    stop = start + base + (1 if rank < rem else 0)
    return items[start:stop]


def _merge_arrays(key: str, reduce_name: Optional[str], payloads: List[Payload], default: Any, rank: int) -> torch.Tensor:
    """Re-reduce one per-host array state over the saved shards (N != M)."""
    shards = torch.stack([_require(p, key) for p in payloads])
    dtype = shards.dtype
    if reduce_name == "sum":
        return shards.sum(0).to(dtype) if rank == 0 else default.detach().cpu()
    if reduce_name == "mean":
        return shards.double().mean(0).to(dtype)
    if reduce_name == "max":
        return shards.amax(0)
    if reduce_name == "min":
        return shards.amin(0)
    raise TopologyError(
        f"state `{key}` has reduction {reduce_name!r}, which cannot be re-reduced"
        " across a host-count change; restore with the same number of hosts"
    )


def _restore_cat_buffer(
    metric: Any, name: str, prefix: str, payloads: List[Payload], rank: int, world: int, saved_world: int
) -> Any:
    from metrics_tpu_torch.core.state import CatBuffer

    live: CatBuffer = getattr(metric, name)
    key = f"{prefix}{name}"
    datas = [_require(p, f"{key}@data") for p in payloads]
    counts = [int(_require(p, f"{key}@count")) for p in payloads]
    flags = [bool(_require(p, f"{key}@overflow")) or c > d.shape[0] for p, c, d in zip(payloads, counts, datas)]
    if world == saved_world and datas[rank].shape[0] == live.capacity:
        # exact resume: the true (possibly past-capacity) count and the flag as saved
        return CatBuffer(
            _owned(datas[rank], metric.device), counts[rank], bool(_require(payloads[rank], f"{key}@overflow"))
        )
    rows = torch.cat([d[: min(c, d.shape[0])] for d, c in zip(datas, counts)], dim=0)
    mine = split_items(list(range(rows.shape[0])), world, rank)
    mine_rows = rows[mine[0] : mine[-1] + 1] if mine else rows[:0]
    if mine_rows.shape[0] > live.capacity:
        raise CapacityError(
            f"cat state `{key}`: {mine_rows.shape[0]} restored rows exceed the live"
            f" CatBuffer capacity {live.capacity}; rebuild the metric with"
            f" `cat_capacity>={mine_rows.shape[0]}` before restoring"
        )
    fill = metric._cat_meta.get(name, ((), None, 0))[2]
    return CatBuffer.from_rows(
        mine_rows, live.capacity, fill_value=fill, dtype=live.data.dtype, overflow=any(flags), device=metric.device
    )


def _restore_list(
    metric: Any, name: str, prefix: str, payloads: List[Payload], rank: int, world: int, saved_world: int
) -> List[torch.Tensor]:
    if world == saved_world:
        return [_owned(v, metric.device) for v in iter_list_items(payloads[rank], prefix, name)]
    items: List[torch.Tensor] = []
    for p in payloads:
        items.extend(iter_list_items(p, prefix, name))
    return [_owned(v, metric.device) for v in split_items(items, world, rank)]


def assign_metric_state(
    metric: Any,
    saved_schema: Dict[str, Any],
    payloads: List[Payload],
    prefix: str = "",
    *,
    rank: int = 0,
    world: int = 1,
    saved_world: int = 1,
    replicated: bool = True,
    update_count: Optional[int] = None,
) -> None:
    """Load the saved state under ``prefix`` into ``metric``, children included.

    ``payloads[h]`` is saved host ``h``'s decoded payload. Call only after
    :func:`~metrics_tpu_torch.ckpt.manifest.validate_schema` accepted the tree.
    """
    for name, spec in saved_schema["states"].items():
        key = f"{prefix}{name}"
        if spec["kind"] == KIND_CAT_BUFFER:
            value = _restore_cat_buffer(metric, name, prefix, payloads, rank, world, saved_world)
        elif spec["kind"] == KIND_LIST:
            value = _restore_list(metric, name, prefix, payloads, rank, world, saved_world)
        elif replicated:
            # one copy exists (host 0 wrote it), every host loads it
            value = _owned(_require(payloads[0], key), metric.device)
        elif world == saved_world:
            value = _owned(_require(payloads[rank], key), metric.device)
        else:
            merged = _merge_arrays(key, spec["reduce"], payloads, metric._defaults[name], rank)
            value = _owned(merged, metric.device)
        setattr(metric, name, value)
    for attr, child_schema in saved_schema["children"].items():
        live_child = child_metrics(metric)[attr]
        if isinstance(child_schema, list):
            for i, (c_metric, c_schema) in enumerate(zip(live_child, child_schema)):
                assign_metric_state(
                    c_metric, c_schema, payloads, f"{prefix}{attr}[{i}]/",
                    rank=rank, world=world, saved_world=saved_world, replicated=replicated,
                    update_count=c_schema.get("update_count"),
                )
        else:
            assign_metric_state(
                live_child, child_schema, payloads, f"{prefix}{attr}/",
                rank=rank, world=world, saved_world=saved_world, replicated=replicated,
                update_count=child_schema.get("update_count"),
            )
    finalize_metric(metric, saved_schema["update_count"] if update_count is None else update_count)


def finalize_metric(metric: Any, update_count: int) -> None:
    """Reset the runtime bookkeeping after a state load, so the metric behaves as if
    it had accumulated the restored state itself."""
    metric._update_count = int(update_count)
    metric._computed = None
    metric._forward_cache = None
    metric._cache = None
    metric._is_synced = False


def slice_fleet_schema(saved: Dict[str, Any]) -> Dict[str, Any]:
    """A saved fleet schema projected onto one stream: no ``fleet_size``, no
    ``_fleet_rows`` state, the leading fleet dim stripped from every array default.
    It validates against a plain instance of the same class."""
    from metrics_tpu_torch.core.fleet import ROWS_STATE

    out = {k: v for k, v in saved.items() if k != "fleet_size"}
    states: Dict[str, Any] = {}
    for name, spec in saved["states"].items():
        if name == ROWS_STATE:
            continue
        spec = dict(spec, default=dict(spec["default"]))
        shape = spec["default"].get("shape")
        if shape:
            spec["default"]["shape"] = list(shape[1:])
        states[name] = spec
    out["states"] = states
    return out


def slice_fleet_payloads(payloads: List[Payload], saved: Dict[str, Any], stream: int, prefix: str = "") -> List[Payload]:
    """Per-host payloads with every fleet state sliced at ``stream`` along the fleet
    axis (``_fleet_rows`` dropped)."""
    from metrics_tpu_torch.core.fleet import ROWS_STATE

    out: List[Payload] = []
    for payload in payloads:
        sliced = dict(payload)
        for name in saved["states"]:
            key = f"{prefix}{name}"
            if name == ROWS_STATE:
                sliced.pop(key, None)
            elif key in sliced:
                sliced[key] = sliced[key][stream]
        out.append(sliced)
    return out


def merged_update_count(schemas: List[Dict[str, Any]], own: Optional[Dict[str, Any]]) -> int:
    """The update count to restore: the restoring host's own on the same topology,
    else the largest over the saved hosts."""
    if own is not None:
        return int(own["update_count"])
    return max(int(s["update_count"]) for s in schemas)
