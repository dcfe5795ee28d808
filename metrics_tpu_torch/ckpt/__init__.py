"""metrics_tpu_torch.ckpt: preemption-safe checkpoint and restore of metric state
(counterpart of ``metrics_tpu/ckpt``, the same on-disk format).

    from metrics_tpu_torch import ckpt

    metric.update(preds, target)
    ckpt.save_checkpoint(metric, "eval-ckpts", retain=3)   # atomic

    # ... the job is preempted and restarts ...
    fresh = MulticlassAccuracy(num_classes=5, average="micro")
    step = ckpt.restore_checkpoint(fresh, "eval-ckpts")     # latest
    fresh.compute()   # identical to the uninterrupted run

- **Atomic and versioned**: ``step_*`` directories committed by one rename; a kill
  mid-save never leaves a readable partial checkpoint; ``retain=N`` prunes.
- **Async**: ``blocking=False`` copies the states on the current stream and writes
  on a background thread (torch states change in place, so the copy is taken before
  the call returns); ``wait_for_all_saves()`` joins the writes.
- **Validated**: restore checks the manifest against the live tree first and raises
  typed errors (:class:`SchemaDriftError`, :class:`CorruptCheckpointError`, ...)
  before touching any state.
- **Topology aware**: host 0 writes replicated states once, every host its cat
  shards; the commit is a barrier-free "all manifests of this generation present"
  check; states saved on N hosts restore onto M by re-reducing sum/max/min states
  and re-packing cat rows.
- **Group aware**: a ``MetricCollection`` saves each compute group's state once (the
  leader's; a fused leader's captured buffers) and restore re-aliases the members.
- **Shared format**: layout, manifest keys, payload index and dtype names are the
  JAX package's; a checkpoint of either package restores into the other wherever
  the states' dtypes agree, and raises :class:`DtypeDriftError` where they do not.

``Metric.save_checkpoint`` / ``restore_checkpoint`` (and the ``MetricCollection``
ones) call this module.
"""
from metrics_tpu_torch.ckpt.errors import (
    CapacityError,
    CheckpointError,
    CheckpointNotFoundError,
    CheckpointTimeoutError,
    CorruptCheckpointError,
    DtypeDriftError,
    IncompleteCheckpointError,
    SchemaDriftError,
    ShapeDriftError,
    TopologyError,
)
from metrics_tpu_torch.ckpt.manager import (
    CheckpointWrite,
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    secure_pending_snapshots,
    wait_for_all_saves,
)
from metrics_tpu_torch.ckpt.manifest import metric_schema, validate_schema

__all__ = [
    "CapacityError",
    "CheckpointError",
    "CheckpointNotFoundError",
    "CheckpointTimeoutError",
    "CheckpointWrite",
    "CorruptCheckpointError",
    "DtypeDriftError",
    "IncompleteCheckpointError",
    "SchemaDriftError",
    "ShapeDriftError",
    "TopologyError",
    "all_steps",
    "latest_step",
    "metric_schema",
    "restore_checkpoint",
    "save_checkpoint",
    "secure_pending_snapshots",
    "validate_schema",
    "wait_for_all_saves",
]
