"""Kendall's merge count on the CPU against the JAX package's four sums and the all-pairs count.

``_plain_merge_pair_counts`` (one sort of packed keys, tiles counted pairwise and
sorted, bottom-up merge levels, run lengths) must give, bit for bit, the JAX package's
int32 sums over its (n, n) sign matrices (``kendall.py:17-30``, through
``jax_pair_counts``) and ``_plain_pair_counts`` (every pair compared). Each case runs
at ``tile`` 4, where a few rows already take many merge levels, and at the card's
tile. The cases: the ties, specials and continuous columns of the regression tests;
all-NaN columns; a single row without NaN; n = 0, 1, 2; a constant column; equal
±inf runs in x and y together; many columns whose NaN-free rows end at different
lengths; lengths at tile - 1, tile, tile + 1 and 2^k tile ± 1.
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch.ops import kendall as tk
from tests.test_torch_regression import _count_cases, jax_pair_counts

TILES = [4, tk.MERGE_TILE]
#: rows of the length cases: tile - 1, tile, tile + 1, 2^k tile ± 1 at tile 4; the card's tile ± 1
LENGTHS = (3, 4, 5, 7, 9, 15, 17, 31, 33, tk.MERGE_TILE - 1, tk.MERGE_TILE, tk.MERGE_TILE + 1)


def _ties_and_specials(n: int, seed: int):
    """Few distinct values, ±0, ±inf and NaN in both columns."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-3, 4, n).astype(np.float32)
    y = rng.randint(-2, 3, n).astype(np.float32)
    pick = rng.rand(n)
    x[pick < 0.05] = np.nan
    x[pick > 0.94] = np.inf
    x[(pick > 0.3) & (pick < 0.34)] = -np.inf
    x[(pick > 0.4) & (pick < 0.45)] = -0.0
    y[pick > 0.97] = -np.inf
    y[(pick > 0.1) & (pick < 0.13)] = np.inf
    y[(pick > 0.5) & (pick < 0.55)] = -0.0
    y[(pick > 0.6) & (pick < 0.66)] = np.nan
    return x, y


def _cases():
    rng = np.random.RandomState(21)
    cases = dict(_count_cases())
    y = rng.randn(30).astype(np.float32)
    cases["x_all_nan"] = (np.full(30, np.nan, np.float32), y)
    cases["y_all_nan"] = (y, np.full(30, np.nan, np.float32))
    cases["one_row_without_nan"] = (np.array([np.nan, 1.0, 2.0, np.nan], np.float32),
                                    np.array([3.0, 1.0, np.nan, np.nan], np.float32))
    for n in (0, 1, 2):
        cases[f"n{n}"] = (rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32))
    cases["constant"] = (np.full(25, 2.5, np.float32), rng.randint(0, 3, 25).astype(np.float32))
    inf_x = np.array([np.inf] * 4 + [-np.inf] * 3 + [1.0, 1.0, np.inf, -np.inf, 0.0], np.float32)
    inf_y = np.array([np.inf, np.inf, -np.inf, np.inf, -np.inf, -np.inf, 2.0, np.inf, np.inf, np.inf, -np.inf, 0.0],
                     np.float32)
    cases["equal_inf_runs"] = (inf_x, inf_y)
    for n in LENGTHS:
        cases[f"length_{n}"] = _ties_and_specials(n, n)
    return cases


CASES = _cases()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_counts_bit_equal_to_jax_sums_and_all_pairs(case, tile):
    x, y = CASES[case]
    got = tk._plain_merge_pair_counts(torch.from_numpy(x), torch.from_numpy(y), tile=tile)
    assert got.dtype == torch.int64 and got.shape == (1, 4)
    np.testing.assert_array_equal(got[0].numpy(), jax_pair_counts(x, y))
    assert torch.equal(got, tk._plain_pair_counts(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.parametrize("tile", TILES)
def test_merge_counts_of_many_columns_with_ragged_nan_free_rows(tile):
    """Each column counts as alone, in one call: the NaN-free rows R of the columns end
    at different lengths (all rows, none, one, and between), NaN in x or in y."""
    n, lengths = 37, (37, 0, 1, 4, 5, 17, 36, 20)
    rng = np.random.RandomState(5)
    x = rng.randint(0, 6, (n, len(lengths))).astype(np.float32)
    y = rng.randint(0, 4, (n, len(lengths))).astype(np.float32)
    for col, keep in enumerate(lengths):
        (x if col % 2 else y)[keep:, col] = np.nan
    x, y = x[rng.permutation(n)], y[rng.permutation(n)]
    got = tk._plain_merge_pair_counts(torch.from_numpy(x), torch.from_numpy(y), tile=tile)
    for col in range(len(lengths)):
        np.testing.assert_array_equal(got[col].numpy(), jax_pair_counts(x[:, col], y[:, col]))
    assert torch.equal(got, tk._plain_pair_counts(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.parametrize("n", [2 * tk.MERGE_TILE - 1, 2 * tk.MERGE_TILE + 1])
def test_merge_counts_past_two_of_the_cards_tiles(n):
    """2 tile ± 1 rows at the card's tile (a merge level of a ragged pair) equal the
    all-pairs count and the tile-4 count (which equals the JAX sums above)."""
    x, y = (torch.from_numpy(v) for v in _ties_and_specials(n, 3))
    got = tk._plain_merge_pair_counts(x, y)
    assert torch.equal(got, tk._plain_pair_counts(x, y))
    assert torch.equal(got, tk._plain_merge_pair_counts(x, y, tile=4))


def test_cpu_pair_counts_take_the_merge_count():
    x, y = (torch.from_numpy(v) for v in _ties_and_specials(50, 8))
    assert torch.equal(tk.pair_counts(x, y), tk._plain_merge_pair_counts(x, y))
    assert tk.KendallPairsKernel.merge_passes(1) == 0
    assert tk.KendallPairsKernel.merge_passes(tk.MERGE_TILE + 1) == 1
    assert tk.KendallPairsKernel.merge_passes(131_072) == 5


def test_merge_count_tile_must_be_a_power_of_two():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="tile must be a power of two"):
        tk._plain_merge_pair_counts(x, x, tile=3)
