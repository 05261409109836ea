"""The tiles of the residual's and the MOOD candidate's kernels
(csrc/residual.cuh): the device-side tile list the candidate launches over
(ops/kernels.tile_list) against a numpy reference on random cell planes,
and the tile each basis takes (kernels.residual_tile).  Torch and numpy
only: no JAX, no card."""

import numpy as np
import pytest
import torch

from dflo_tpu_torch.ops import kernels

TILES = ((8, 16), (8, 8), (4, 8), (4, 4))


def reference(cells: np.ndarray, ty: int, tx: int) -> np.ndarray:
    """The row-major indices of the ty x tx tiles holding a set cell."""
    ny, nx = cells.shape
    nty, ntx = -(-ny // ty), -(-nx // tx)
    flags = np.zeros((nty, ntx), bool)
    for i in range(nty):
        for j in range(ntx):
            flags[i, j] = cells[i * ty:(i + 1) * ty, j * tx:(j + 1) * tx].any()
    return np.flatnonzero(flags.ravel())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("seed", range(5))
def test_tile_list_matches_numpy(seed, tile):
    rng = np.random.default_rng(seed)
    ny, nx = rng.integers(1, 70, 2)
    density = (0.002, 0.02, 0.2, 0.6, 1.0)[seed]
    cells = rng.uniform(size=(ny, nx)) < density
    lst, count = kernels.tile_list(torch.from_numpy(cells), *tile)
    ref = reference(cells, *tile)
    assert lst.dtype == torch.int32 and count.dtype == torch.int32
    assert tuple(count.shape) == (1,) and int(count) == ref.size
    assert lst.numel() == -(-ny // tile[0]) * -(-nx // tile[1])
    assert lst[:ref.size].tolist() == ref.tolist()


@pytest.mark.parametrize("shape", ((1, 1), (3, 2), (2, 37), (40, 1)))
def test_tile_list_edges(shape):
    """An empty plane lists no tile, a full one every tile, one set corner
    cell the corner tile; planes smaller than one tile."""
    for tile in TILES:
        ntiles = -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])
        empty = torch.zeros(shape, dtype=torch.bool)
        lst, count = kernels.tile_list(empty, *tile)
        assert int(count) == 0 and lst.numel() == ntiles
        lst, count = kernels.tile_list(~empty, *tile)
        assert int(count) == ntiles
        assert lst.tolist() == list(range(ntiles))
        corner = empty.clone()
        corner[-1, -1] = True
        lst, count = kernels.tile_list(corner, *tile)
        assert int(count) == 1 and int(lst[0]) == ntiles - 1


def test_residual_tile_fits_the_block():
    """Every degree's tile gives each thread of the lift at most one
    register tile (4 modes x 4 cells of one component), 8 x 8 at P4."""
    for K in sorted({(p + 1) * (p + 2) // 2 for p in range(1, 7)}
                    | {(p + 1) ** 2 for p in range(1, 7)}):
        for dtype in (torch.float32, torch.float64):
            ty, tx = kernels.residual_tile(K, dtype)
            assert (ty, tx) in TILES
            assert 4 * -(-K // 4) * (ty * tx // 4) <= kernels.TILE_THREADS
            assert ty * tx <= (128 if dtype == torch.float32 else 64)
    assert kernels.residual_tile(15, torch.float32) == (8, 8)
    assert kernels.residual_tile(6, torch.float32) == (8, 16)
    assert kernels.residual_tile(6, torch.float64) == (8, 8)
    assert kernels.residual_tile(49, torch.float64) == (4, 4)
