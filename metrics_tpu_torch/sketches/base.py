"""Base class of the mergeable sketch metrics (counterpart of
``metrics_tpu/sketches/base.py``).

A sketch's whole registered state is a few fixed-shape integer tensors under a
``sum``, ``max`` or ``min`` reduction. That is what makes a process-group sync, the
fleet's per-stream fold and :meth:`SketchMetric.merge` the same exact operation, and
what lets the states take part in fused collections and fleets like any dense state.
:meth:`SketchMetric.add_sketch_state` enforces it when a state is registered.
"""
from typing import Any, Dict, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.exceptions import MetricsUserError

#: the reductions whose pairwise merge is the distributed collective
_MERGEABLE_REDUCTIONS = ("sum", "max", "min")


class SketchMetric(Metric):
    """Base class of the sketches: states through :meth:`add_sketch_state`, the eager
    pairwise :meth:`merge`, and :meth:`state_bytes`."""

    is_differentiable: bool = False
    higher_is_better = None
    full_state_update: bool = False

    def add_sketch_state(self, name: str, default: torch.Tensor, dist_reduce_fx: str) -> None:
        """Register a sketch state: a fixed-shape integer tensor under a mergeable
        reduction; anything else raises :class:`MetricsUserError`."""
        if dist_reduce_fx not in _MERGEABLE_REDUCTIONS:
            raise MetricsUserError(
                f"Sketch state `{name}` must use a mergeable reduction"
                f" {_MERGEABLE_REDUCTIONS}, got {dist_reduce_fx!r}"
            )
        default = torch.as_tensor(default)
        if default.is_floating_point() or default.is_complex() or default.dtype == torch.bool:
            raise MetricsUserError(
                f"Sketch state `{name}` must be an integer array (got {default.dtype}):"
                " integer state is what makes the merge exact and TMS-UPCAST-safe"
            )
        self.add_state(name, default, dist_reduce_fx=dist_reduce_fx)

    def merge(self, other: Union["SketchMetric", Dict[str, Any]]) -> None:
        """Merge another sketch of the same class (or a state dict) into this one, in
        place: ``a.merge(b); a.compute()`` equals a compute over both input streams.
        Associative and commutative."""
        if isinstance(other, Metric) and type(other) is not type(self):
            raise MetricsUserError(
                f"Cannot merge {type(other).__name__} into {type(self).__name__}:"
                " sketch merges are only defined between instances of the same class"
            )
        self.merge_state(other)

    def state_bytes(self) -> int:
        """Bytes of the registered states: the memory a stream costs."""
        return sum(getattr(self, name).numel() * getattr(self, name).element_size() for name in self._defaults)
