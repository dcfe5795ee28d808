"""HyperLogLog approximate distinct counting (Flajolet et al., 2007); counterpart of
``metrics_tpu/sketches/distinct.py``."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.ops.sketch import hash_u32, hll_estimate, hll_index_rank
from metrics_tpu_torch.sketches.base import SketchMetric


class DistinctCount(SketchMetric):
    """Approximate number of distinct values seen, in ``2^p`` bytes of state.

    Each value hashes to a u32 (``ops/sketch.py``); its top ``p`` bits pick one of
    ``m = 2^p`` uint8 registers, which keeps the running max of the rank of the rest.
    The estimate's standard error is ``1.04/sqrt(m)``, with the linear-counting and
    32-bit saturation corrections. ``dist_reduce_fx="max"``: the register max is the
    merge, exact in any order. The update is a ``scatter_reduce`` ``amax`` into the
    uint8 registers (plain PyTorch; no kernel of the repository serves it).

    Args:
        p: register-count exponent (4 to 16).
        seed: hash seed; sketches merge only with the same seed.
    """

    higher_is_better = None
    _update_signature_attrs = ("p", "seed")

    def __init__(self, p: int = 12, seed: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or not 4 <= p <= 16:
            raise ValueError(f"Argument `p` must be an int in [4, 16], got {p}")
        self.p = p
        self.seed = int(seed)
        self.add_sketch_state("registers", torch.zeros(1 << p, dtype=torch.uint8), "max")

    def update(self, values: Tensor) -> None:
        """Hash a batch of values (any shape, flattened) into the registers."""
        values = torch.as_tensor(values, device=self.device)
        idx, rank = hll_index_rank(hash_u32(values.reshape(-1), self.seed), self.p)
        self.registers = self.registers.scatter_reduce(0, idx, rank, "amax", include_self=True)

    def compute(self) -> Tensor:
        """Bias-corrected cardinality estimate (float32; 0 when empty)."""
        return hll_estimate(self.registers)
