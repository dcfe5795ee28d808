"""Registry snapshot export: JSONL dumps for offline analysis and dashboards
(counterpart of ``metrics_tpu/obs/export.py``).

One registry snapshot is one JSON line, so that a long-running evaluation can append
a line an epoch and the file stays easy to grep and to load.

Line contract (``export_schema.json`` beside this module is the normative JSON-schema
copy, the port's own copy of the JAX package's; :func:`validate_snapshot` is the
dependency-free validator):

- ``schema_version``: integer stamp, bumped on breaking layout changes. History: 1 =
  the original ``{enabled, registry}`` pair; 2 added ``schema_version`` and
  ``enabled_now`` and made ``enabled`` describe the *recorded* counters; 3 added the
  optional ``flows`` stats object written while ``obs.flow`` traces
  (``validate_snapshot`` accepts every earlier version; v3 only adds fields).
- ``enabled``: the gate state in effect for the counters in this line. A scoped
  ``observe()`` window that recorded counters and then exited leaves the gate off
  while the snapshot holds enabled-mode data: ``enabled`` reports True for that line.
- ``enabled_now``: the gate at export time.
- ``registry``: ``{scope: {name: number | {count, total_s, max_s}}}``.
"""
import json
import time
from typing import Any, Dict, Optional

from metrics_tpu_torch.obs import registry as _reg

#: current layout stamp of exported lines (see module docstring for history)
SCHEMA_VERSION = 3


def snapshot(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Registry contents as one JSON-serializable dict (plus caller extras)."""
    import sys

    enabled_now = _reg.enabled()
    out: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "enabled": enabled_now or _reg.REGISTRY.recorded(),
        "enabled_now": enabled_now,
        "registry": _reg.snapshot(),
    }
    # tracing tier, on demand: the field only appears while a tracer is live
    _flow = sys.modules.get("metrics_tpu_torch.obs.flow")
    if _flow is not None and _flow.active():
        out["flows"] = _flow.stats()
    if extra:
        out.update(extra)
    return out


def dump_jsonl(path: str, extra: Optional[Dict[str, Any]] = None, clock: Any = time.time) -> Dict[str, Any]:
    """Append one snapshot line to ``path``; returns the dict that was written."""
    record = snapshot(extra)
    record["time_unix"] = float(clock())
    with open(path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True, default=str) + "\n")
    return record


def validate_snapshot(record: Dict[str, Any]) -> None:
    """Validate one exported line against the schema; raises ``ValueError``.

    Dependency-free mirror of ``export_schema.json``, so that the check needs no
    ``jsonschema``.
    """
    if not isinstance(record, dict):
        raise ValueError("snapshot line must be a JSON object")
    sv = record.get("schema_version")
    if not isinstance(sv, int) or isinstance(sv, bool) or sv < 1:
        raise ValueError(f"schema_version must be a positive integer, got {sv!r}")
    for field in ("enabled", "enabled_now"):
        if not isinstance(record.get(field), bool):
            raise ValueError(f"`{field}` must be a boolean, got {record.get(field)!r}")
    reg = record.get("registry")
    if not isinstance(reg, dict):
        raise ValueError("`registry` must be an object")
    for scope, counters in reg.items():
        if not isinstance(counters, dict):
            raise ValueError(f"registry[{scope!r}] must be an object")
        for name, value in counters.items():
            if isinstance(value, bool):
                raise ValueError(f"registry[{scope!r}][{name!r}] must be numeric")
            if isinstance(value, (int, float)):
                continue
            if isinstance(value, dict):
                missing = {"count", "total_s", "max_s"} - set(value)
                if missing or not all(
                    isinstance(value[k], (int, float)) and not isinstance(value[k], bool)
                    for k in ("count", "total_s", "max_s")
                ):
                    raise ValueError(
                        f"registry[{scope!r}][{name!r}] timer must carry numeric"
                        f" count/total_s/max_s, got {value!r}"
                    )
                continue
            raise ValueError(
                f"registry[{scope!r}][{name!r}] must be a number or timer object,"
                f" got {type(value).__name__}"
            )
    if "time_unix" in record and not isinstance(record["time_unix"], (int, float)):
        raise ValueError("`time_unix` must be numeric when present")
    if "flows" in record:
        flows = record["flows"]
        if not isinstance(flows, dict):
            raise ValueError("`flows` must be an object when present")
        for name, value in flows.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise ValueError(f"flows[{name!r}] must be numeric, got {value!r}")
