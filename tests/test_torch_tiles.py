"""The tiles of the tile kernels: the residual's and the MOOD candidate's
(csrc/residual.cuh): the device-side tile list the candidate launches over
(ops/kernels.tile_list) against a numpy reference on random cell planes,
and the tile each basis takes (kernels.residual_tile); the post's and the
modal positivity's (csrc/fused_post.cu, csrc/fused_modal_pos.cu): the tile
each degree takes (kernels.post_tile) against the block size and the
shared-memory budget, and the diag partials, one per tile, against the
tiles that cover a ragged grid; the Pk post's and the MOOD check's
(csrc/fused_pk_post.cu, csrc/fused_mood_check.cu): the Pk post's tile at
every degree and dtype (kernels.pk_post_tile) and the check's block
(kernels.check_tile) against the block and the budget, the Pk post's diag
partials against its tiles, and the constants the wrappers mirror from
the sources.  Torch and numpy only: no JAX, no card."""

import re

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


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("modal", (False, True))
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_post_tile_fits_the_block_and_the_budget(p, modal, dtype):
    """Every degree of the post (Q1-Q6) and the modal positivity (P1-P6)
    takes a tile whose cells each get a thread of the chain (the post's
    two), whose shared memory, in every form, fits the budget (two blocks
    per SM; the float64 post, one block per SM, the card's) and whose
    float32 cells x K stay within MODAL_TILE_DOFS for the modal positivity;
    no larger tile of the list passes all three.  The post's per-cell forms
    (float32 Q1-Q2, float64 Q1) take their thread block, BLOCK, and no
    shared memory."""
    ty, tx = kernels.post_tile(p, modal, dtype)
    if not modal and p <= kernels.POST_CELL_MAX_P[dtype]:
        assert (ty, tx) == kernels.BLOCK
        assert kernels.post_smem(p, modal, dtype, (ty, tx)) == 0
        return
    assert (ty, tx) in kernels.POST_TILES
    threads = ty * tx * (1 if modal else 2)    # the post's chain: two a cell
    assert threads <= kernels.TILE_THREADS and (ty * tx) % 4 == 0
    forms = ((True, True),) if modal else ((False, False), (False, True),
                                           (True, False), (True, True))
    budget = (kernels.MAX_SMEM if not modal and dtype == torch.float64
              else kernels.POST_SMEM)
    for masked, pos in forms:
        b = kernels.post_smem(p, modal, dtype, (ty, tx), masked, pos)
        assert 0 < b <= budget <= kernels.MAX_SMEM and b % 16 == 0
    K = (p + 1) * (p + 2) // 2 if modal else (p + 1) ** 2
    dofs = kernels.MODAL_TILE_DOFS[dtype] if modal else None
    assert dofs is None or ty * tx * K <= dofs
    larger = kernels.POST_TILES[:kernels.POST_TILES.index((ty, tx))]
    assert all(kernels.post_smem(p, modal, dtype, t) > budget
               or t[0] * t[1] * (1 if modal else 2) > kernels.TILE_THREADS
               or (dofs is not None and t[0] * t[1] * K > dofs)
               for t in larger)


def test_post_tiles_of_the_main_paths():
    """The tiles of the main paths' forms: the Q2 and Q1 posts (RK/TVB
    DMR, the forward step) on the per-cell kernel's 4 x 32 block in
    float32, the Q3 post on 8 x 16, Q4 and Q5 on 8 x 8, Q6 on 4 x 8, the
    P2, P3 and P4 modal positivity on 16 x 16, 8 x 16 and 8 x 16 (the cap
    of 2,000 modes a tile); in float64 the post on the tiles its one block
    per SM allows, Q4 on 8 x 8 and Q6 on 4 x 8, whose staged state alone
    takes 4 * 49 * 60 * 8 B."""
    f32, f64 = torch.float32, torch.float64
    assert kernels.post_tile(2, False, f32) == kernels.BLOCK == (4, 32)
    assert kernels.post_tile(1, False, f32) == kernels.BLOCK
    assert kernels.post_tile(2, False, f64) == (8, 16)
    assert kernels.post_tile(3, False, f32) == (8, 16)
    assert kernels.post_tile(4, False, f32) == (8, 8)
    assert kernels.post_tile(5, False, f32) == (8, 8)
    assert kernels.post_tile(2, True, f32) == (16, 16)
    assert kernels.post_tile(4, True, f32) == (8, 16)
    assert kernels.post_tile(3, True, f32) == (8, 16)
    assert kernels.post_tile(6, False, f32) == (4, 8)
    assert kernels.post_tile(4, False, f64) == (8, 8)
    assert kernels.post_tile(6, False, f64) == (4, 8)
    assert kernels.post_smem(6, False, f64, (4, 8)) > 4 * 49 * 60 * 8


@pytest.mark.parametrize("tile", kernels.POST_TILES + ((4, 32),))
@pytest.mark.parametrize("shape", ((1, 1), (3, 2), (2, 37), (40, 1),
                                   (17, 9), (288, 1152), (33, 65)))
def test_diag_partials_number_the_tiles(shape, tile):
    """The diag partials of a launch (one per tile: thread 0 of block b
    writes slot b) number the tiles the kernel's blocks decode, which
    cover every cell of a ragged grid exactly once; the partials' tensors
    are sized from the tile in Python, with no built library."""
    ny, nx = shape
    ty, tx = tile
    n = kernels.tile_count(ny, nx, tile)
    ntx = -(-nx // tx)
    cover = np.zeros((ny, nx), int)
    for b in range(n):
        y0, x0 = (b // ntx) * ty, (b % ntx) * tx
        assert y0 < ny and x0 < nx
        cover[y0:y0 + ty, x0:x0 + tx] += 1
    assert (cover == 1).all()
    u = torch.zeros((4, 1, ny, nx), dtype=torch.float64)
    lam, minq = kernels._partials(u, tile)
    assert lam.shape == minq.shape == (n,) and lam.dtype == u.dtype


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_pk_post_tile_fits_the_block_and_the_budget(p, dtype):
    """Every degree of the Pk post takes a tile of POST_TILES whose cells
    get a thread each at least (two, the chain's x and y halves, on tiles
    of up to TILE_THREADS / 2 cells), whose cells x K stay within
    PK_TILE_DOFS and whose shared memory fits the budget (POST_SMEM, two
    blocks per SM, in float32; MAX_SMEM in float64); no larger tile of the
    list passes; the per-cell degrees (PK_POST_CELL_MAX_P) take BLOCK and
    no shared memory."""
    tile = kernels.pk_post_tile(p, dtype)
    if p <= kernels.PK_POST_CELL_MAX_P[dtype]:
        assert tile == kernels.BLOCK
        assert kernels.pk_post_smem(p, dtype, tile) == 0
        return
    K = (p + 1) * (p + 2) // 2
    budget = (kernels.POST_SMEM if dtype == torch.float32
              else kernels.MAX_SMEM)

    def fits(t):
        return (kernels.TILE_THREADS % (t[0] * t[1]) == 0
                and t[0] * t[1] * K <= kernels.PK_TILE_DOFS[dtype]
                and kernels.pk_post_smem(p, dtype, t) <= budget)
    assert tile in kernels.POST_TILES and fits(tile)
    b = kernels.pk_post_smem(p, dtype, tile)
    assert 0 < b <= kernels.MAX_SMEM and b % 16 == 0
    assert not any(fits(t) for t in
                   kernels.POST_TILES[:kernels.POST_TILES.index(tile)])


def test_pk_post_tiles_of_the_main_paths():
    """The Pk post on the MOOD paths: P1 (the DMR P1 path) and P2 (the DMR
    P2, rt and fwd paths) on the per-cell kernel's 4 x 32 block in both
    dtypes, P3 there in float32 and on 8 x 16 in float64, P4 on 8 x 16 in
    both dtypes
    (1,920 modes of a component), P5 on 8 x 16 in float32 and 8 x 8 in
    float64, P6 on 8 x 8; the layout's bytes at P4 float32 by hand: the
    transposed points, the modes, the points' values (in the space of the
    ring's means, which are fewer), the shock values and the per-cell
    values."""
    f32, f64 = torch.float32, torch.float64
    assert kernels.pk_post_tile(1, f32) == kernels.pk_post_tile(1, f64) \
        == kernels.pk_post_tile(2, f32) == kernels.pk_post_tile(2, f64) \
        == kernels.pk_post_tile(3, f32) == kernels.BLOCK == (4, 32)
    assert kernels.pk_post_tile(3, f64) == (8, 16)
    assert kernels.pk_post_tile(4, f32) == kernels.pk_post_tile(4, f64) \
        == (8, 16)
    assert kernels.pk_post_tile(5, f32) == (8, 16)
    assert kernels.pk_post_tile(5, f64) == (8, 8)
    assert kernels.pk_post_tile(6, f32) == kernels.pk_post_tile(6, f64) \
        == (8, 8)
    qpp, K, nc, ss = 40, 15, 128, 10 * 18
    assert 4 * ss < qpp * nc
    assert kernels.pk_post_smem(4, f32, (8, 16)) == 4 * (
        K * qpp + 4 * K * nc + qpp * nc + nc + 7 * nc)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_check_tiles_fit_the_budget(dtype):
    """The check's block in each dtype: the per-cell kernel's BLOCK (no
    dynamic shared memory) where CHECK_PER_CELL says, else the wide
    CHECK_TILE, its columns a multiple of 16 (a byte plane's 16-byte
    vector, so the tile's vectors start aligned), its cells runs of four
    along x, its shared memory (two D2 planes with a two-cell halo, five
    planes with a one-cell halo, the flags, each row padded so that a run
    of four cells is one aligned vector) within the card's, by hand in
    float32."""
    if kernels.CHECK_PER_CELL[dtype]:
        assert kernels.check_tile(dtype) == kernels.BLOCK
        assert kernels.check_smem(dtype) == 0
        return
    ty, tx = kernels.check_tile(dtype)
    assert (ty, tx) == kernels.CHECK_TILE
    assert tx % 16 == 0 and (ty * tx) % 4 == 0
    b = kernels.check_smem(dtype)
    assert 0 < b <= kernels.MAX_SMEM and b % 16 == 0
    if dtype == torch.float32:
        pt, rows = tx + 8, ty + 2
        assert b == (2 * (ty + 4) * pt * 4 + 3 * rows * pt * 4
                     + rows * (tx + 8) * 4 + rows * (tx + 32)
                     + 2 * rows * (tx + 8))


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("shape", ((1, 1), (9, 17), (40, 3), (288, 1152)))
@pytest.mark.parametrize("p", (1, 2, 4, 6))
def test_pk_post_partials_number_its_tiles(p, shape, dtype):
    """The Pk post's diag partials (one per tile: thread 0 of block b
    writes slot b) number the tiles of pk_post_tile over the grid, which
    its blocks decode row-major and which cover every cell once."""
    ny, nx = shape
    tile = kernels.pk_post_tile(p, dtype)
    n = kernels.tile_count(ny, nx, tile)
    u = torch.zeros((4, (p + 1) * (p + 2) // 2, ny, nx), dtype=dtype)
    lam, minq = kernels._partials(u, tile)
    assert lam.shape == minq.shape == (n,) and lam.dtype == dtype
    cover = np.zeros(shape, int)
    ntx = -(-nx // tile[1])
    for b in range(n):
        y0, x0 = (b // ntx) * tile[0], (b % ntx) * tile[1]
        cover[y0:y0 + tile[0], x0:x0 + tile[1]] += 1
    assert (cover == 1).all()


def _constant(source: str, pattern: str) -> int:
    """The integer a C source of the kernels defines by pattern."""
    text = (kernels.CSRC / source).read_text()
    found = re.findall(pattern, text)
    assert len(found) == 1, (source, pattern, found)
    return int(found[0])


@pytest.mark.parametrize("name", ("BLOCK", "POST_CELL_MAX_P", "TILE_THREADS",
                                  "POINT_ROWS", "MAX_SMEM",
                                  "PK_POST_CELL_MAX_P", "CHECK_TILE",
                                  "CHECK_PER_CELL", "VOLUME_CELL_MAX_P",
                                  "DIAG_THREADS", "DIAG_RUN"))
def test_python_mirrors_match_the_sources(name):
    """Each constant the wrappers mirror from the C sources (the per-cell
    kernels' block, which sizes their diag partials; the post's per-cell
    degrees; the tile kernels' threads, point rows and shared-memory
    ceiling; the Pk post's per-cell degrees; the check's tile and the
    dtypes of its per-cell kernel; the volume residual's per-cell degrees
    and its tile kernel's threads; the diag's threads and run of cells per
    thread, which size its grid and workspace) equals the sources' own, read
    from csrc/ as built by default (chip_smoke.py phase 1 asks the built
    library for the block and the shared memory on the card)."""
    if name == "BLOCK":
        got = (_constant("euler.cuh", r"constexpr int BY = (\d+);"),
               _constant("euler.cuh", r"constexpr int BX = (\d+);"))
        assert got == kernels.BLOCK
    elif name == "POST_CELL_MAX_P":
        got = {dt: _constant("fused_post.cu",
                             rf"#define DFLO_POST_CELL_MAX_P_{tag} (\d+)")
               for dt, tag in ((torch.float32, "F32"),
                               (torch.float64, "F64"))}
        assert got == kernels.POST_CELL_MAX_P
    elif name == "TILE_THREADS":
        assert _constant("tile.cuh", r"constexpr int TNT = (\d+);") \
            == kernels.TILE_THREADS
    elif name == "PK_POST_CELL_MAX_P":
        got = {dt: _constant("fused_pk_post.cu",
                             rf"#define DFLO_PK_POST_CELL_MAX_P_{tag} (\d+)")
               for dt, tag in ((torch.float32, "F32"),
                               (torch.float64, "F64"))}
        assert got == kernels.PK_POST_CELL_MAX_P
        assert max(got.values()) <= 3    # the fixed dims alone
    elif name == "CHECK_TILE":
        got = (_constant("fused_mood_check.cu",
                         r"constexpr int CHECK_TY = (\d+), CHECK_TX = \d+;"),
               _constant("fused_mood_check.cu",
                         r"constexpr int CHECK_TY = \d+, CHECK_TX = (\d+);"))
        assert got == kernels.CHECK_TILE
    elif name == "CHECK_PER_CELL":
        got = {dt: bool(_constant("fused_mood_check.cu",
                                  rf"#define DFLO_CHECK_PER_CELL_{tag} (\d+)"))
               for dt, tag in ((torch.float32, "F32"),
                               (torch.float64, "F64"))}
        assert got == kernels.CHECK_PER_CELL
    elif name == "VOLUME_CELL_MAX_P":
        got = {dt: _constant("volume_residual.cu",
                             rf"#define DFLO_VOLUME_CELL_MAX_P_{tag} (\d+)")
               for dt, tag in ((torch.float32, "F32"),
                               (torch.float64, "F64"))}
        assert got == kernels.VOLUME_CELL_MAX_P
        assert max(got.values()) <= 3    # registers up to Q3
        assert _constant("volume_residual.cu",
                         r"constexpr int VOL_THREADS = (\d+);") \
            == kernels.TILE_THREADS
    elif name == "DIAG_THREADS":
        assert _constant("fused_diag.cu",
                         r"constexpr int DIAG_THREADS = (\d+);") \
            == kernels.DIAG_THREADS
    elif name == "DIAG_RUN":
        assert _constant("fused_diag.cu",
                         r"constexpr int DIAG_RUN = (\d+);") \
            == kernels.DIAG_RUN
    elif name == "POINT_ROWS":
        assert _constant("tile.cuh", r"constexpr int PR = (\d+);") \
            == kernels.POINT_ROWS
    else:
        assert _constant("tile.cuh", r"constexpr int MAX_SMEM = (\d+);") \
            == kernels.MAX_SMEM
