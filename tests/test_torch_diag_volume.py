"""The diag (csrc/fused_diag.cu) and the collocated volume residual
(csrc/volume_residual.cu) as their kernels compute them, on the CPU.

- The diag's mode-0 mean: on a modal Pk basis the diag reads mode 0 alone
  (avg[0] * u[:, 0]).  Its plain version at P1-P6, masked and not, and on
  an over-integrated P2 (4 x 4 Gauss points) gives the dt of the JAX
  package's XLA path (rk.compute_dt on Solver.cell_averages, which takes
  the Pk mean from mode 0 too) within 1e-12, and (lam_max, minq) of the
  reference's make_fused_diag (the full mean-weight row, in interpret
  mode) within 1e-13 relative, in float64: the rows differ by quadrature
  round-off alone.
- The volume residual's summation walk: a torch emulation of the tile
  kernel's order (each output node's row and column entries in ascending
  k, the x term before the y term where they cross, from the
  tensor-product coefficient table the kernel stages) and of the per-cell
  kernel's (the whole lift, its zeros skipped) equals
  volume_residual_plain bitwise at Q1-Q6 and GLL1-GLL6, f32 and f64.
- The lift's pattern check (kernels.check_volume_lift, which make_rhs runs
  once for volume_kernel="pallas"): a nonzero entry outside a node's row
  or column raises, as does a lift of the wrong shape.
- The diag's workspace (two partials per block of its grid, sized from
  the grid and the SM count) and the volume residual's tiles (each within
  the shared-memory budget, a warp's cells on one node).

Grids 32 x 16 or smaller; the JAX side compiles one diag per case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.ops.pallas_kernels import make_fused_diag
from dflo_tpu.solver import rk as jrk
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler

NX, NY = 32, 16
F64 = torch.float64
CFL = 0.5


def pk_state(basis, seed: int) -> np.ndarray:
    """A positive Pk state [4, K, NY, NX]: cell means around the DMR's
    post-shock state (2 % noise), higher modes 1 % of the mean."""
    rng = np.random.default_rng(seed)
    mean = np.array([8.25 * 0.866, -8.25 * 0.5, 8.0, 563.5])
    u = np.zeros((4, basis.K, NY, NX))
    avg0 = kernels.mode0_mean(basis)
    u[:, 0] = (mean[:, None, None] / avg0
               * (1.0 + 0.02 * rng.uniform(-1, 1, (4, NY, NX))))
    u[:, 1:] = 0.01 * u[:, :1] * rng.uniform(-1, 1, (4, basis.K - 1, NY, NX))
    return u


def solid_block() -> np.ndarray:
    mask = np.ones((NY, NX), bool)
    mask[3:7, 20:26] = False
    return mask


CASES = [(p, None, m) for p in range(1, 7) for m in (False, True)] + [
    (2, 4, False)]


@pytest.mark.parametrize("p, nq, masked", CASES)
def test_pk_diag_mode0_matches_jax(p, nq, masked):
    mask = solid_block() if masked else None
    tb, jb = make_basis("Pk", p, nq), jax_make_basis("Pk", p, nq)
    u = pk_state(tb, seed=10 * p + masked)
    if masked:    # solid cells hold a negative density: excluded
        u[:, :, ~mask] = -1.0
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 2.0)
    ops = kernels.diag_operators(tb, mesh, mask=mask, dtype=F64,
                                 device="cpu")
    assert ops.mode0 and ops.part is None and ops.ticket is None
    ut = torch.from_numpy(u)
    assert torch.equal(kernels.diag_means(ut, ops), ops.avg[0] * ut[:, 0])
    lam, minq = kernels.fused_diag_plain(ut, ops)
    assert torch.equal(torch.stack(kernels.fused_diag(ut, ops)),
                       torch.stack((lam, minq)))
    assert float(minq) > 0.0
    # the JAX package's XLA path: rk.compute_dt on Solver.cell_averages
    jmesh = JMesh(NX, NY, 0.0, 4.0, 0.0, 2.0)
    js = JSolver(jb, jmesh, graft._build(NX, NY)[0].bcs, cfl=CFL,
                 dtype=jnp.float64, mask=mask)
    uj = jnp.asarray(u)
    dt_ref = float(jrk.compute_dt(js.cell_averages(uj), jmesh, p, CFL,
                                  mask=None if mask is None
                                  else jnp.asarray(mask)))
    dt = CFL / float(lam) / (2.0 * p + 1.0)
    assert abs(dt - dt_ref) <= 1e-12 * dt_ref
    # the reference's fused diag (full mean-weight row), interpret mode
    lam_j, minq_j = make_fused_diag(jb, jmesh, dtype=jnp.float64,
                                    mask=mask)(uj)
    assert abs(float(lam) - float(lam_j)) <= 1e-13 * abs(float(lam_j))
    assert abs(float(minq) - float(minq_j)) <= 1e-13 * abs(float(minq_j))


def test_nodal_diag_reads_the_full_row():
    """Qk, GLL and the over-integrated Qk keep the full row; a Pk basis
    whose tail is not round-off would too (none exists here)."""
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 2.0)
    for fam, p, nq in (("Qk", 2, None), ("Qk_gll", 3, None), ("Qk", 2, 4)):
        ops = kernels.diag_operators(make_basis(fam, p, nq), mesh, dtype=F64,
                                     device="cpu")
        assert not ops.mode0
        u = torch.rand((4, ops.K, 3, 5), dtype=F64,
                       generator=torch.Generator().manual_seed(p))
        ref = ops.avg[0] * u[:, 0]
        for k in range(1, ops.K):
            ref = ref + ops.avg[k] * u[:, k]
        assert torch.equal(kernels.diag_means(u, ops), ref)


# ---------------------------------------------------------------------------
# the volume residual's summation walk
# ---------------------------------------------------------------------------

def coefficient_table(lift: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's staged table C [K, 2n]: row m's x entries on its own
    row of nodes, then its y entries on its own column."""
    K = n * n
    C = torch.empty((K, 2 * n), dtype=lift.dtype)
    for m in range(K):
        im, jm = m % n, m // n
        for a in range(n):
            C[m, a] = lift[m, n * jm + a]
            C[m, n + a] = lift[m, K + im + n * a]
    return C


def tile_walk(lift: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tile_volume_kernel's phase B on every cell at once."""
    K = u.shape[1]
    n = round(K ** 0.5)
    Fx, Fy = euler.flux_x(u), euler.flux_y(u)
    C = coefficient_table(lift, n)
    out = torch.empty_like(u)
    for m in range(K):
        im, jm = m % n, m // n
        R = torch.zeros_like(u[:, 0])
        for b in range(n):
            if b != jm:
                R = R + C[m, n + b] * Fy[:, im + n * b]
                continue
            for a in range(n):
                R = R + C[m, a] * Fx[:, n * jm + a]
                if a == im:
                    R = R + C[m, n + jm] * Fy[:, m]
        out[:, m] = R
    return out


def cell_walk(lift: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cell_volume_kernel's order: k ascending, the nonzero x then y
    entries of the whole lift."""
    K = u.shape[1]
    Fx, Fy = euler.flux_x(u), euler.flux_y(u)
    out = torch.empty_like(u)
    for m in range(K):
        R = torch.zeros_like(u[:, 0])
        for k in range(K):
            if lift[m, k] != 0:
                R = R + lift[m, k] * Fx[:, k]
            if lift[m, K + k] != 0:
                R = R + lift[m, K + k] * Fy[:, k]
        out[:, m] = R
    return out


def nodal_state(basis, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    mean = np.array([1.5, -0.7, 1.4, 6.0])
    u = mean[:, None, None, None] * (1.0 + 0.1 * rng.uniform(
        -1, 1, (4, basis.K, 6, 10)))
    return torch.from_numpy(u).to(dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("family", ("Qk", "Qk_gll"))
@pytest.mark.parametrize("p", range(1, 7))
def test_volume_walk_is_bitwise_plain(p, family, dtype):
    from dflo_tpu_torch.entry import dmr_inflow
    from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs
    basis = make_basis(family, p)
    mesh = CartesianMesh(10, 6, 0.0, 4.0, 0.0, 1.0)
    bcs = dict(W=BoundarySide(euler.BC_INFLOW, dmr_inflow),
               E=BoundarySide(euler.BC_OUTFLOW),
               S=BoundarySide(euler.BC_SLIP),
               N=BoundarySide(euler.BC_FARFIELD, dmr_inflow))
    rhs = make_rhs(basis, mesh, bcs, dtype=dtype, device="cpu",
                   volume_kernel="pallas")
    lift = rhs.lift_stack
    u = nodal_state(basis, dtype, seed=p)
    plain = kernels.volume_residual_plain(lift, u)
    assert torch.equal(tile_walk(lift, u), plain)
    assert torch.equal(cell_walk(lift, u), plain)
    assert torch.equal(kernels.volume_residual(lift, u), plain)


@pytest.mark.parametrize("family", ("Qk", "Qk_gll"))
@pytest.mark.parametrize("p", (1, 2, 4, 6))
def test_volume_lift_off_the_pattern_raises(p, family):
    basis = make_basis(family, p)
    n, K = p + 1, basis.K
    lift = np.concatenate([0.3 * (basis.wq2[:, None] * basis.Gx).T,
                           0.7 * (basis.wq2[:, None] * basis.Gy).T], axis=1)
    kernels.check_volume_lift(basis, lift)
    bad = lift.copy()
    bad[K - 1, 0] = 1e-30          # x entry of node (p, p) on row 0
    with pytest.raises(ValueError, match="row"):
        kernels.check_volume_lift(basis, bad)
    bad = lift.copy()
    bad[0, K + 1] = -2.0           # y entry of node (0, 0) in column 1
    with pytest.raises(ValueError, match="column"):
        kernels.check_volume_lift(basis, bad)
    with pytest.raises(ValueError, match="shape"):
        kernels.check_volume_lift(basis, lift[:, :K])
    with pytest.raises(ValueError, match="collocated"):
        kernels.check_volume_lift(make_basis("Pk", p), lift)
    assert n * n == K


# ---------------------------------------------------------------------------
# the diag's workspace and the volume residual's tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ((1, 1), (3, 5), (20, 96), (288, 1152),
                                   (640, 1920), (2048, 2048)))
def test_diag_workspace_is_sized_from_the_grid(shape):
    ny, nx = shape
    sms = 132
    part, ticket = kernels.diag_workspace(ny, nx, F64, "cpu", sms)
    runs = ny * -(-nx // kernels.DIAG_RUN)
    blocks = min(-(-runs // kernels.DIAG_THREADS),
                 sms * kernels.DIAG_BLOCKS_PER_SM)
    assert part.numel() == 2 * blocks and part.dtype == F64
    assert ticket.dtype == torch.int32 and int(ticket) == 0
    assert kernels.diag_grid(ny, nx, part.numel() // 2) == blocks
    # every run has a thread at most DIAG_BLOCKS_PER_SM waves deep in
    # blocks of the grid-stride loop; a smaller grid (a block of a
    # mesh) takes fewer
    assert blocks * kernels.DIAG_THREADS * -(-runs // (
        blocks * kernels.DIAG_THREADS)) >= runs
    assert kernels.diag_grid(max(1, ny // 2), max(1, nx // 2),
                             part.numel() // 2) <= blocks


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("p", range(1, 7))
def test_volume_tile_fits_the_budget(p, dtype):
    """Each degree's tile: the per-cell kernel (no shared memory) up to the
    cap, above it VOLUME_TILE_X cells (a warp's: the warp's threads share
    one node in both phases) whose fluxes and coefficient table fit the
    block's shared memory with room for at least two blocks an SM."""
    K = (p + 1) ** 2
    tx = kernels.volume_tile(K, dtype)
    if p <= kernels.VOLUME_CELL_MAX_P[dtype]:
        assert tx == 0 and kernels.volume_smem(p, dtype) == 0
        return
    assert tx == kernels.VOLUME_TILE_X and tx % 32 == 0
    smem = kernels.volume_smem(p, dtype)
    size = torch.finfo(dtype).bits // 8
    assert smem == (8 * K * tx + 2 * (p + 1) * K) * size
    assert 2 * smem <= kernels.MAX_SMEM
