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
nor concordant nor discordant, as ``jnp.sign`` of it makes it there. ±0 tie; denormals
keep IEEE order. Counts are int64.

The same four integers come from a sort (Knight, 1966), in O(N log N) work per column.
With C(k, 2) = k (k - 1) / 2 and R the rows where neither x nor y is NaN:

- ``x_tied`` = Σ C(k, 2) over the groups of equal finite x (every row, whatever its
  y); ``y_tied`` likewise;
- ``Ex``, ``Ey``, ``Exy`` = Σ C(k, 2) over the groups of equal x, y and (x, y) in R,
  infinities included as values; ``concordant + discordant`` = C(|R|, 2) - Ex - Ey + Exy;
- ``discordant`` = the strict inversions of y when R is sorted by (x, y).

One sort gives all of it: each row's packed int64 key (:func:`_packed_keys`) sorts R
first by (x, y), then the rows whose y alone is NaN by x (tail A), then those whose x
alone is NaN by y (tail B), then the rows with both NaN. Tail A's groups of equal x
join R's groups of the same x (``x_tied`` adds C(k1 + k2, 2) = C(k1, 2) + C(k2, 2) +
k1 k2), tail B's join the groups of equal y read off R's merged y (below).

- **CPU tensors:** :func:`_plain_merge_pair_counts`, that decomposition step for step
  in plain PyTorch: the sort, tiles counted and sorted, bottom-up merge levels whose
  right elements each add the left elements above them
  (``torch.searchsorted(left, right, right=True)``), run lengths.
- **CUDA tensors:** :data:`kendall_pairs_cuda`, the same chain on the card with no host
  read: the key kernel, ``torch.sort`` of the packed keys, then the hand-written tile,
  merge, tie-run and finish kernels of ``csrc/kendall_merge.cu`` (all C columns in each
  launch; ⌈log₂(N / tile)⌉ merge launches). There is no fallback: a CUDA input the chain
  does not take raises.

:func:`_plain_pair_counts`, all pairs compared in row chunks (O(N²)), is the
independent oracle of both in the tests and in ``chip_smoke.py``.
"""
from typing import Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch import _build

#: bytes of float32 differences one chunk of the all-pairs version holds
_PLAIN_CHUNK_BYTES = 1 << 30
#: bools one chunk of the tile stage's pairwise comparisons holds
_TILE_CHUNK_ELEMENTS = 1 << 26
#: rows a tile of the card's tile pass sorts in shared memory (``csrc/kendall_merge.cu:kTile``)
MERGE_TILE = 4096
#: rows a card call takes per column (the C functions refuse more)
MAX_ROWS = (1 << 31) - 1
MAX_COLUMNS = 65535  # grid.y

# the high 32 bits of the packed key of a row outside R (above every float's key):
_HI_TAIL_A = 0x7FFFFFFD  # y NaN, x not: the low 32 bits hold x's key
_HI_TAIL_B = 0x7FFFFFFE  # x NaN, y not: the low 32 bits hold y's key
_HI_BOTH_NAN = 0x7FFFFFFF
_PAD = (1 << 32) - 1  # y's key past R in the merge buffers: above every float's key
_U_NEG_INF, _U_POS_INF = 0x007FFFFF, 0xFF800000  # the order keys of -inf and +inf


def _as_columns(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.shape != y.shape or x.dim() not in (1, 2):
        raise ValueError(f"kendall pair counts: x and y must be (N,) or (N, C) of one shape, got {tuple(x.shape)}"
                         f" and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"kendall pair counts: x on {x.device}, y on {y.device}")
    if x.dim() == 1:
        x, y = x[:, None], y[:, None]
    return x.to(torch.float32), y.to(torch.float32)


# ------------------------------------------------------------ all pairs (the oracle)


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
    ``i < j`` of each column of ``x, y`` ``(N, C)``: every pair compared, in plain
    PyTorch (any device)."""
    x, y = _as_columns(x, y)
    n, c = x.shape
    if n < 2:
        return torch.zeros((c, 4), dtype=torch.int64, device=x.device)
    rows = max(1, _PLAIN_CHUNK_BYTES // (4 * n * c))
    chunks = [
        _chunk_counts(x[a:a + rows], y[a:a + rows], x[a:], y[a:]) for a in range(0, n - 1, rows)
    ]
    return _sum_chunk_counts(chunks)


# ------------------------------------------------------------------- the merge count


def _order_keys(v: Tensor) -> Tensor:
    """int64 in [0, 2^32): each float32's order-preserving key, -0 taken as +0."""
    bits = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -1 - bits, bits + (1 << 31))


def _packed_keys(x: Tensor, y: Tensor) -> Tensor:
    """``(C, N)`` int64 keys of the rows of ``x, y`` ``(N, C)``: high 32 bits x's signed
    key in R, else the tail's marker; low 32 bits y's key in R and tail B, x's in tail A."""
    x, y = x.t(), y.t()
    ux, uy = _order_keys(x), _order_keys(y)
    xn, yn = torch.isnan(x), torch.isnan(y)
    hi = torch.where(xn, torch.where(yn, _HI_BOTH_NAN, _HI_TAIL_B), torch.where(yn, _HI_TAIL_A, ux - (1 << 31)))
    lo = torch.where(xn, torch.where(yn, 0, uy), torch.where(yn, ux, uy))
    return hi * (1 << 32) + lo


def _runs(keys: Tensor, member: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(column, key, length) of each run of equal keys among the ``member`` positions of
    ``keys`` ``(C, M)``, each row sorted where it is a member."""
    start = member.clone()
    start[:, 1:] &= (keys[:, 1:] != keys[:, :-1]) | ~member[:, :-1]
    run = torch.cumsum(start.reshape(-1).to(torch.int64), 0) - 1
    length = torch.bincount(run[member.reshape(-1)], minlength=int(start.sum()))
    return torch.nonzero(start)[:, 0], keys[start], length


def _pairs(k: Tensor) -> Tensor:
    return k * (k - 1) // 2


def _per_column(c: int, column: Tensor, value: Tensor) -> Tensor:
    return torch.zeros(c, dtype=torch.int64, device=value.device).index_add_(0, column, value)


def _count_in_rows(rows: Tensor, column: Tensor, value: Tensor) -> Tensor:
    """How many times each ``value`` (in [0, 2^32)) occurs in row ``column`` of ``rows``
    ``(C, M)``, rows sorted, entries in [0, 2^32)."""
    offset = torch.arange(rows.shape[0], device=rows.device)[:, None] << 33
    flat = (rows + offset).reshape(-1)
    q = value + (column << 33)
    return torch.searchsorted(flat, q, right=True) - torch.searchsorted(flat, q)


def _tile_inversions(tiles: Tensor) -> Tensor:
    """Strict inversions of each tile ``(..., T)``: the pairs a < b with ``t_a > t_b``."""
    flat = tiles.reshape(-1, tiles.shape[-1])
    t = flat.shape[1]
    upper = torch.ones((t, t), dtype=torch.bool, device=tiles.device).triu(1)
    step = max(1, _TILE_CHUNK_ELEMENTS // (t * t))
    counts = [((f[:, :, None] > f[:, None, :]) & upper).sum((1, 2)) for f in flat.split(step)]
    return torch.cat(counts).reshape(tiles.shape[:-1])


def _plain_merge_pair_counts(x: Tensor, y: Tensor, tile: int = MERGE_TILE) -> Tensor:
    """``(C, 4)`` int64 counts of ``x, y`` ``(N,)`` or ``(N, C)`` as
    :func:`_plain_pair_counts` gives them, by the card's chain in plain PyTorch: one
    sort of the packed keys, tiles of ``tile`` rows (a power of two) sorted with their
    inversions counted pairwise, bottom-up merge levels, run lengths."""
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"kendall merge count: tile must be a power of two, got {tile}")
    x, y = _as_columns(x, y)
    n, c = x.shape
    dev = x.device
    keys = torch.sort(_packed_keys(x, y), dim=1).values
    hi, lo = keys >> 32, keys & 0xFFFFFFFF
    in_r, in_a, in_b = hi < _HI_TAIL_A, hi == _HI_TAIL_A, hi == _HI_TAIL_B
    length = in_r.sum(1)

    # y of R in (x, y) order, padded to whole tiles and a power of two of them
    tiles = max(1, -(-n // tile))
    width = 1 << (tiles - 1).bit_length()
    ys = torch.full((c, width * tile), _PAD, dtype=torch.int64, device=dev)
    ys[:, :n] = torch.where(in_r, lo, _PAD)
    ys = ys.view(c, width, tile)
    dis = _tile_inversions(ys).sum(1)
    ys = torch.sort(ys, dim=2).values
    run = tile
    while ys.shape[1] > 1:
        pairs = ys.view(c, -1, 2, run)
        left, right = pairs[:, :, 0].contiguous(), pairs[:, :, 1].contiguous()
        above = run - torch.searchsorted(left, right, right=True)  # left elements > each right one
        dis += above.sum((1, 2))
        run *= 2
        ys = torch.sort(pairs.reshape(c, -1, run), dim=2).values
    merged = ys.reshape(c, -1)[:, :n]

    col, hx, k = _runs(hi, in_r)
    ex = _per_column(c, col, _pairs(k))
    finite = (hx != _U_NEG_INF - (1 << 31)) & (hx != _U_POS_INF - (1 << 31))
    x_tied = _per_column(c, col[finite], _pairs(k[finite]))
    col, _, k = _runs(keys, in_r)
    exy = _per_column(c, col, _pairs(k))
    col, vy, k = _runs(merged, in_r)
    ey = _per_column(c, col, _pairs(k))
    finite = (vy != _U_NEG_INF) & (vy != _U_POS_INF)
    y_tied = _per_column(c, col[finite], _pairs(k[finite]))
    # tails: groups of one finite value join R's groups of it
    for member, rows, tied in ((in_a, hi + (1 << 31), x_tied), (in_b, torch.where(in_r, merged, _PAD), y_tied)):
        col, v, k2 = _runs(lo, member)
        finite = (v != _U_NEG_INF) & (v != _U_POS_INF)
        col, v, k2 = col[finite], v[finite], k2[finite]
        k1 = _count_in_rows(rows, col, v)
        tied += _per_column(c, col, _pairs(k2) + k1 * k2)
    total = length * (length - 1) // 2 - ex - ey + exy
    return torch.stack([total - dis, dis, x_tied, y_tied], dim=1)


class KendallPairsKernel:
    """Wrapper of the merge-count chain (``csrc/kendall_merge.cu``): checks, the launches,
    the counts. ``launches`` grows by one per call, and nowhere else; ``kernel_launches``
    by the chain's hand-written kernels (the key kernel, the tile pass, the merge passes,
    the tie-run and finish kernels).
    """

    def __init__(self) -> None:
        self.launches = 0
        self.kernel_launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            lib = _build.load("kendall_merge")
            if lib.tm_kendall_tile_rows() != MERGE_TILE:
                raise RuntimeError("kendall merge kernels: csrc/kendall_merge.cu's tile differs from MERGE_TILE")
            self._lib = lib
        return self._lib

    @staticmethod
    def merge_passes(n: int) -> int:
        """The merge launches of one chain call at ``n`` rows: ⌈log₂(⌈n / tile⌉)⌉."""
        return (max(1, -(-n // MERGE_TILE)) - 1).bit_length()

    def __call__(self, x: Tensor, y: Tensor) -> Tensor:
        """``(C, 4)`` int64 counts of CUDA ``x, y`` ``(N,)`` or ``(N, C)``, as
        :func:`_plain_pair_counts`."""
        if x.device.type != "cuda":
            raise ValueError(f"kendall pairs kernel: inputs must be CUDA tensors, got one on {x.device}")
        x, y = _as_columns(x, y)
        n, c = x.shape
        if c > MAX_COLUMNS:
            raise ValueError(f"kendall pairs kernel: takes at most {MAX_COLUMNS} columns, got {c}")
        if n > MAX_ROWS:
            raise ValueError(f"kendall pairs kernel: takes at most {MAX_ROWS} rows, got {n}")
        out = torch.empty((c, 4), dtype=torch.int64, device=x.device)
        if c == 0:
            return out
        self._merge(x, y, out)
        self.kernel_launches += 4 + self.merge_passes(n) if n > 0 else 1
        _build.note_launch(self)
        return out

    def _merge(self, x: Tensor, y: Tensor, out: Tensor) -> None:
        """The chain on float32 ``x, y`` ``(N, C)`` into ``out`` ``(C, 4)``; counts nothing."""
        n, c = x.shape
        x, y = x.contiguous(), y.contiguous()
        lib = self._library()
        stride = max(1, -(-n // MERGE_TILE)) * MERGE_TILE
        packed = torch.empty((c, n), dtype=torch.int64, device=x.device)
        scratch = torch.empty((c, 16), dtype=torch.int64, device=x.device)  # zeroed by the key call
        err = _build.call_on_device(x.device, lambda s: lib.tm_kendall_keys(
            x.data_ptr(), y.data_ptr(), n, c, packed.data_ptr(), scratch.data_ptr(), s))
        if err != 0:
            raise RuntimeError(f"kendall key kernel launch failed with CUDA error {err}")
        keys = torch.sort(packed, dim=1).values
        buffers = torch.empty((2, c, stride), dtype=torch.int32, device=x.device)
        err = _build.call_on_device(x.device, lambda s: lib.tm_kendall_count(
            keys.data_ptr(), n, c, buffers[0].data_ptr(), buffers[1].data_ptr(), stride, scratch.data_ptr(),
            out.data_ptr(), s))
        if err != 0:
            raise RuntimeError(f"kendall merge-count kernels launch failed with CUDA error {err}")


kendall_pairs_cuda = KendallPairsKernel()


def pair_counts(x: Tensor, y: Tensor) -> Tensor:
    """``(C, 4)`` int64 ``(concordant, discordant, x_tied, y_tied)`` of each column.

    The chain on the card for CUDA inputs (one call whatever C), the plain merge count
    for CPU inputs (the device of ``x`` decides).
    """
    if _build.faking(x, y):
        return torch.ops.metrics_tpu_torch.pair_counts(x, y)
    return _pair_counts_direct(x, y)


def _pair_counts_direct(x: Tensor, y: Tensor) -> Tensor:
    if x.device.type == "cuda":
        return kendall_pairs_cuda(x, y)
    return _plain_merge_pair_counts(x, y)


@torch.library.custom_op("metrics_tpu_torch::pair_counts", mutates_args=())
def _pair_counts_op(x: Tensor, y: Tensor) -> Tensor:
    """Kendall's pair counts as a custom op, so that a trace on fake tensors holds one
    node with the chain's output shape (:func:`pair_counts` on real tensors)."""
    return _pair_counts_direct(x, y)


@_pair_counts_op.register_fake
def _pair_counts_fake(x: Tensor, y: Tensor) -> Tensor:
    if x.shape != y.shape or x.dim() not in (1, 2):
        _as_columns(x, y)  # raises its error
    return x.new_empty((1 if x.dim() == 1 else x.shape[1], 4), dtype=torch.int64)
