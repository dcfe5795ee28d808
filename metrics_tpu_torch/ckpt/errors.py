"""Typed errors of the checkpoint subsystem (counterpart of ``metrics_tpu/ckpt/errors.py``).

Each failure mode of a restore has its own type, so that a caller can branch on it
(retry an older step on corruption, rebuild the metric on schema drift) instead of
parsing messages. All derive from :class:`CheckpointError`.
"""


class CheckpointError(Exception):
    """Base class of every checkpoint and restore failure."""


class CheckpointNotFoundError(CheckpointError):
    """No committed checkpoint exists at the directory or step asked for."""


class IncompleteCheckpointError(CheckpointError):
    """A step directory exists but was never committed (killed mid-save), or a
    committed one lacks a per-host file that its commit record promises."""


class CorruptCheckpointError(CheckpointError):
    """A manifest or payload fails its integrity checks (unparseable JSON, a
    truncated payload, a CRC mismatch, an unknown dtype name)."""


class CheckpointTimeoutError(CheckpointError):
    """``wait_for_all_saves(timeout_s=...)`` reached its deadline with saves still
    in flight; ``steps`` lists their step numbers."""

    def __init__(self, message: str, steps: tuple = ()) -> None:
        super().__init__(message)
        self.steps = tuple(steps)


class SchemaDriftError(CheckpointError):
    """The saved state tree does not match the live metric's (classes, state names,
    kinds or reductions differ)."""


class ShapeDriftError(SchemaDriftError):
    """A saved array state's shape differs from the live metric's."""


class DtypeDriftError(SchemaDriftError):
    """A saved state's dtype differs from the live metric's. A checkpoint of the
    JAX package restores into the port (and back) only where the dtypes agree; the
    port's listed int64 deviations raise this instead of casting."""


class CapacityError(CheckpointError):
    """Restored cat rows do not fit the live ``CatBuffer``'s capacity."""


class TopologyError(CheckpointError):
    """The saved host topology cannot be mapped onto the restoring one (a state
    with a ``None`` or callable reduction saved on N hosts, restored onto M != N)."""
