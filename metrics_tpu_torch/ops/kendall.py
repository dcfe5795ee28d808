"""Kendall's pair counts: concordant, discordant, x-tied and y-tied pairs of every column.

Counterpart of ``metrics_tpu/functional/regression/kendall.py:_kendall_stats_1d``
(:17-43), which the JAX package computes with two ``(n, n)`` sign matrices of float32
differences and int32 sums over their upper triangle, one column at a time. That form
holds 2·n² values (17 GB at n = 65,536) and its int32 sums wrap past n = 65,536.
Here, for ``x, y`` of shape ``(N, C)``, each pair ``i < j`` of a column counts by the
float32 signs of ``x_i - x_j`` and ``y_i - y_j``:

- concordant where their product is > 0, discordant where it is < 0;
- x-tied where ``x_i - x_j == 0``, y-tied where ``y_i - y_j == 0``.

A NaN difference (a NaN value, or equal infinities: inf - inf is NaN) is neither tied
nor concordant nor discordant, as ``jnp.sign`` of it makes it there. Counts are int64.

- **CPU tensors:** :func:`_plain_pair_counts`, row chunks of plain PyTorch
  comparisons, about 1 GB of differences a chunk. It is also the kernel's reference
  in the tests and in ``chip_smoke.py``.
- **CUDA tensors:** the hand-written kernel in ``csrc/kendall_pairs.cu`` through
  :data:`kendall_pairs_cuda`, one launch for all C columns. There is no fallback: a
  CUDA input the kernel does not take raises.
"""
from typing import Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build

#: bytes of float32 differences one chunk of the plain version holds
_PLAIN_CHUNK_BYTES = 1 << 30


def _as_columns(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.shape != y.shape or x.dim() not in (1, 2):
        raise ValueError(f"kendall pair counts: x and y must be (N,) or (N, C) of one shape, got {tuple(x.shape)}"
                         f" and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"kendall pair counts: x on {x.device}, y on {y.device}")
    if x.dim() == 1:
        x, y = x[:, None], y[:, None]
    return x.to(torch.float32), y.to(torch.float32)


def _sum_chunk_counts(chunks: Sequence[Tensor]) -> Tensor:
    """The per-chunk ``(C, 4)`` counts summed in int64: exact past 2^31."""
    return torch.stack([c.to(torch.int64) for c in chunks]).sum(0)


def _chunk_counts(xi: Tensor, yi: Tensor, xo: Tensor, yo: Tensor) -> Tensor:
    """Counts of the rows ``xi, yi`` against the rows after each of them in ``xo, yo``,
    which start at the first of them: ``(C, 4)`` int64."""
    dx = xi[:, None, :] - xo[None, :, :]
    dy = yi[:, None, :] - yo[None, :, :]
    later = torch.arange(xo.shape[0], device=xo.device)[None, :] > torch.arange(xi.shape[0], device=xo.device)[:, None]
    later = later[:, :, None]
    pos_x, neg_x, pos_y, neg_y = dx > 0, dx < 0, dy > 0, dy < 0
    concordant = ((pos_x & pos_y) | (neg_x & neg_y)) & later
    discordant = ((pos_x & neg_y) | (neg_x & pos_y)) & later
    return torch.stack(
        [m.sum((0, 1), dtype=torch.int64) for m in (concordant, discordant, (dx == 0) & later, (dy == 0) & later)],
        dim=1,
    )


def _plain_pair_counts(x: Tensor, y: Tensor) -> Tensor:
    """``(C, 4)`` int64 counts (concordant, discordant, x-tied, y-tied) over the pairs
    ``i < j`` of each column of ``x, y`` ``(N, C)``, in plain PyTorch (any device)."""
    x, y = _as_columns(x, y)
    n, c = x.shape
    if n < 2:
        return torch.zeros((c, 4), dtype=torch.int64, device=x.device)
    rows = max(1, _PLAIN_CHUNK_BYTES // (4 * n * c))
    chunks = [
        _chunk_counts(x[a:a + rows], y[a:a + rows], x[a:], y[a:]) for a in range(0, n - 1, rows)
    ]
    return _sum_chunk_counts(chunks)


class KendallPairsKernel:
    """Wrapper of the CUDA pair-count kernel: checks, launch, and a count of launches.

    ``launches`` grows by one each time the kernel is launched, and nowhere else.
    """

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = _build.load("kendall_pairs").tm_kendall_pairs
        return self._fn

    def __call__(self, x: Tensor, y: Tensor) -> Tensor:
        """``(C, 4)`` int64 counts of CUDA ``x, y`` ``(N,)`` or ``(N, C)``, as :func:`_plain_pair_counts`."""
        if x.device.type != "cuda":
            raise ValueError(f"kendall pairs kernel: inputs must be CUDA tensors, got one on {x.device}")
        x, y = _as_columns(x, y)
        n, c = x.shape
        if c > 65535:
            raise ValueError(f"kendall pairs kernel: takes at most 65535 columns, got {c}")
        out = torch.empty((c, 4), dtype=torch.int64, device=x.device)
        if c == 0:
            return out
        # columns contiguous: the kernel reads row tiles of one column
        xt, yt = x.t().contiguous(), y.t().contiguous()
        fn = self._function()
        err = _build.call_on_device(
            x.device, lambda stream: fn(xt.data_ptr(), yt.data_ptr(), n, c, out.data_ptr(), stream)
        )
        if err != 0:
            raise RuntimeError(f"kendall pairs kernel launch failed with CUDA error {err}")
        self.launches += 1
        return out


kendall_pairs_cuda = KendallPairsKernel()


def pair_counts(x: Tensor, y: Tensor) -> Tensor:
    """``(C, 4)`` int64 ``(concordant, discordant, x_tied, y_tied)`` of each column.

    The kernel for CUDA inputs (one launch whatever C), the plain version for CPU
    inputs (the device of ``x`` decides).
    """
    if x.device.type == "cuda":
        return kendall_pairs_cuda(x, y)
    return _plain_pair_counts(x, y)
