"""Each CUDA kernel of dflo_tpu_torch against its plain PyTorch version, on
the card: the RK/TVB kernels for every instantiated degree (p = 1, 2, 3),
the MOOD kernels for p = 2 and 3 (96 x 24, modal Pk; the check p = 2-6),
in both dtypes; the post's block form and the sharded diag on a (2, 2)
virtual mesh (and over distinct cards where there are two or more); the
modal LxF residual in its
three forms (p = 1, 2, 3) and the LxF candidate (p = 2, 3, bitwise) at the
ragged ny = 4 and 10, and the Q1 post periodic on both axes (the vortex
system's), with and without its diag; the residual's source arms (gravity
and the force planes on Qk, GLL and Pk, isothermal well-balancing on GLL
and Qk, hllc and lxf, p = 1, 2, 3, at the ragged 40 x 10), the diag on GLL
and the f64 well-balance drift through the kernel at 64 x 64; the Roe,
Steger-Warming, KFVS and KEP forms of the residual (Qk, GLL and Pk, p = 1
and 2, and masked Q1) and the source arms' refusal of them; one f64
implicit step with the kernel primal against the plain primal; the masked
modal residual (the forward step on P1-P3, all six fluxes, three forms,
its launch keys, a solid cell's R exactly 0), the MOOD candidate with roe,
sw, kfvs and kep (p = 2, 3, bitwise, on a cell set and on every cell), and
three f64 MOOD steps through the kernels against the same steps through
the plain versions on the masked P2 forward step and with gravity; the
envelope of the residual (every flux at p = 4-6 on Qk, GLL and Pk, the
over-integrated bases, masked forms, the source arms with roe, sw, kfvs
and kep), the post on Q4-Q6 masked and not, the diag on every new basis
kind, volume_residual at K = 25, 36, 49, and the refusals of MOOD at
p = 7 and of a basis beyond NQ_MAX on the card; the MOOD kernels over the
whole degree range (the general candidate at p 4-6 with every flux and on
the over-integrated P2, the modal positivity in its four forms, the Pk
post with and without diag and the check at p 4-6, all bitwise) and three
f64 MOOD steps on P4 and on P1 through the kernels against the plain
versions; the tile kernels' edges (the residual and the candidate share one
tile kernel, csrc/residual.cuh): grids cut against every tile and smaller
than one, periodic wrap faces, solid cells on tile and domain edges, every
source arm, the candidate on the four corners, an empty and a full set, and
the candidate's tile-list kernel against its plain twin, all bitwise; the
post's and the modal positivity's tile kernels (and the post's per-cell
kernel at Q1-Q2) on the same kind of grids: the post at Q1-Q6 periodic in
x, y and both, with the three indicators, char_lim and pos_lim off, solid
cells on tile and domain edges and a NaN cell, its block form with each
halo line present and absent, the modal positivity at P1-P6 in its four
forms with a degree map holding every degree 0..p, all bitwise; the Pk
post's and the MOOD check's tile kernels on the same kind of grids: the Pk
post at P1-P6 periodic on neither, one or both axes, with marked cells on
tile and domain edges and a NaN cell, the check at p 2-6 with degree-1
marked cells on tile and domain edges, so that spreads cross tile borders
and wrap, all bitwise; the diag (one launch a call, the Pk mode-0 mean,
the nodal full row, masked, over-integrated, on ragged and unaligned
states and a narrow workspace), its sharded form and the volume residual
at Q1-Q6 and GLL1-GLL6, all bitwise, and a diag call traced as one
kernel; the physics envelope: the masked Q1 stage on a pressure outlet's
strips, bitwise, the MOOD cascade off the fused route launching no MOOD
kernel, and minmax and u2 steps on the card against the CPU port.

Marked ``gpu``; without a CUDA device every test skips.  The file imports no
JAX, so it also runs on a machine with the card and no JAX (tests/conftest.py
imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances, relative to the plain version's largest magnitude per
component: f64 1e-11 and f32 1e-5 (1e-4 for the post chains), the round-off
of another summation order and of FMA contraction.  The MOOD check's
integer and flag outputs are bitwise equal, and so are the diag's and the
volume residual's outputs (rows 6, 7 and 1) in every test.  The f32 post may flip a
limiter threshold decision (KXRCF > 1, change > 1e-10) in a few cells; those
are counted and bounded by 1 % of the cells at this small size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dflo_tpu_torch import ic
from dflo_tpu_torch.entry import dmr_ic, dmr_inflow
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import (BoundarySide, SegmentedSide,
                                           make_rhs)
from dflo_tpu_torch.stab.positivity import EPS

pytestmark = pytest.mark.gpu

NX, NY = 96, 20          # 20 rows: ragged against the 8-row tiles
TOL = {torch.float64: 1e-11, torch.float32: 1e-5}
POST_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
BCS = dict(W=BoundarySide(euler.BC_INFLOW, dmr_inflow),
           E=BoundarySide(euler.BC_OUTFLOW),
           S=BoundarySide(euler.BC_SLIP),
           N=BoundarySide(euler.BC_FARFIELD, dmr_inflow))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def rel(k, p) -> float:
    k, p = k.double(), p.double()
    if k.dim() == 0:
        return float((k - p).abs() / p.abs().clamp(min=1e-300))
    num = (k - p).abs().flatten(1).amax(1)
    return float((num / p.abs().flatten(1).amax(1).clamp(min=1e-300)).max())


def setup(p, dtype, device):
    """Operators and a limited, perturbed DMR state on Q_p."""
    basis = make_basis("Qk", p)
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    gen = torch.Generator().manual_seed(p)
    u = ic.set_initial_condition(basis, mesh, dmr_ic, dtype=torch.float64,
                                 device="cpu")
    u = u * (1.0 + 0.05 * (2.0 * torch.rand(u.shape, generator=gen,
                                            dtype=torch.float64) - 1.0))
    u = u.to(dtype=dtype, device=device)
    post = kernels.post_operators(basis, mesh, indicator="density", beta=2.0,
                                  char_lim=True, pos_lim=True,
                                  dtype=dtype, device=device)
    rhs = make_rhs(basis, mesh, BCS, flux="hllc", dtype=dtype, device=device,
                   volume_kernel="fused")
    diag = kernels.diag_operators(basis, mesh, dtype=dtype, device=device)
    return u, post, rhs, diag


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_fused_residual_matches_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    u, post, rhs, _ = setup(p, dt, cuda)
    u = kernels.fused_post_plain(u, post)
    strips = rhs.strips(u, 0.0)
    before = kernels.fused_residual.launches
    R = kernels.fused_residual(u, *strips, rhs.ops)
    assert rel(R, kernels.fused_residual_plain(u, *strips, rhs.ops)) <= TOL[dt]
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    S = kernels.fused_residual(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    Sp = kernels.fused_residual_plain(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    torch.cuda.synchronize()
    assert rel(S, Sp) <= TOL[dt]
    assert kernels.fused_residual.launches == before + 2


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_fused_post_and_diag_match_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    u, post, _, diag = setup(p, dt, cuda)
    k0 = kernels.fused_post(u, post)
    k, lam, minq = kernels.fused_post(u, post, with_diag=True)
    pl, lam_p, minq_p = kernels.fused_post_plain(u, post, with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(k, k0)
    scale = pl.double().abs().flatten(1).amax(1)
    cell = ((k.double() - pl.double()).abs()
            / scale[:, None, None, None]).amax((0, 1))
    flipped = cell > POST_TOL[dt]
    assert int(flipped.sum()) <= (0 if dt == torch.float64 else NX * NY // 100)
    assert float(torch.where(flipped, 0.0, cell).max()) <= POST_TOL[dt]
    assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]
    lam_d, minq_d = kernels.fused_diag(u, diag)
    lam_dp, minq_dp = kernels.fused_diag_plain(u, diag)
    assert same_bits(lam_d, lam_dp) and same_bits(minq_d, minq_dp)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_nan_cell_reaches_the_fatal_flag(cuda, dtype):
    dt = getattr(torch, dtype)
    u, post, _, diag = setup(2, dt, cuda)
    u[:, :, NY // 2, NX // 3] = float("nan")
    _, minq = kernels.fused_diag(u, diag)
    _, _, minq2 = kernels.fused_post(u, post, with_diag=True)
    assert bool(~(minq >= EPS)) and bool(~(minq2 >= EPS))


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    u, post, rhs, diag = setup(2, torch.float64, cuda)
    strips = rhs.strips(u, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_post(u.transpose(2, 3), post)
    with pytest.raises(ValueError):
        kernels.fused_residual(u, *strips, rhs.ops, u_old=u)
    with pytest.raises(ValueError, match="share"):
        kernels.fused_diag(u.float(), diag)
    with pytest.raises(ValueError, match="strip"):
        kernels.fused_residual(u, strips[2], strips[1], strips[2], strips[3],
                               rhs.ops)


# ---------------------------------------------------------------------------
# the MOOD kernels on the modal Pk basis
# ---------------------------------------------------------------------------

PK_NX, PK_NY = 96, 24


def setup_pk(p, dtype, device, seed=0, ny=PK_NY, flux="hllc", nq=None,
             nx=PK_NX):
    """Operators and a positivity-limited, perturbed DMR state on P_p (on
    nq x nq quadrature points, p + 1 unless given), a mixed degree map and
    random cell/limiter planes (numpy seed)."""
    basis = make_basis("Pk", p, nq)
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    rng = np.random.default_rng(seed)
    u = ic.set_initial_condition(basis, mesh, dmr_ic, dtype=torch.float64,
                                 device="cpu")
    u = u * torch.from_numpy(1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    mops64 = kernels.modal_operators(basis, mesh, dtype=torch.float64,
                                     device="cpu")
    u = kernels.modal_tp_plain(u, None, mops64).to(dtype=dtype, device=device)
    rhs = make_rhs(basis, mesh, BCS, flux=flux, dtype=dtype, device=device,
                   volume_kernel="fused")
    planes = dict(
        deg=torch.from_numpy(rng.integers(1, p + 1, (ny, nx),
                                          dtype=np.int32)).to(device),
        cells=torch.from_numpy(rng.uniform(size=(ny, nx)) < 0.3
                               ).to(device),
        lim=torch.from_numpy(rng.uniform(size=(ny, nx)) < 0.2
                             ).to(device),
        shock=torch.from_numpy(np.where(rng.uniform(size=(ny, nx))
                                        < 0.5, 2.0, 0.0)).to(dtype=dtype,
                                                             device=device))
    return basis, mesh, u, rhs, planes


def cell_flips(k, p, tol):
    """(max relative error outside flipped cells, flipped cells)."""
    scale = p.double().abs().flatten(1).amax(1)
    cell = ((k.double() - p.double()).abs()
            / scale[:, None, None, None]).amax((0, 1))
    flipped = cell > tol
    return float(torch.where(flipped, 0.0, cell).max()), int(flipped.sum())


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (2, 3))
def test_modal_residual_and_candidate_match_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, pl = setup_pk(p, dt, cuda, seed=p)
    strips = rhs.strips(u, 0.0)
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    for kw in ({}, {"dt": h}):
        k = kernels.fused_residual(u, *strips, rhs.ops, **kw)
        assert rel(k, kernels.fused_residual_plain(u, *strips, rhs.ops, **kw)) \
            <= TOL[dt]
    # the candidate on a random cell set and on every cell, in place
    mops = rhs.modal_ops
    tp_strips = rhs.strips(u, 0.0, pl["deg"])
    prev = u.flip(-1).contiguous()
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        before = kernels.fused_mood_candidate.launches
        k = kernels.fused_mood_candidate(u, prev.clone(), pl["deg"], cells,
                                         *tp_strips, rhs.ops, mops, h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), pl["deg"],
                                               cells, *tp_strips, rhs.ops,
                                               mops, h)
        torch.cuda.synchronize()
        assert kernels.fused_mood_candidate.launches == before + 1
        e, flips = cell_flips(k, q, TOL[dt])
        assert e <= TOL[dt] and flips == 0
        assert torch.equal(k[..., ~cells], prev[..., ~cells])


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (2, 3))
def test_modal_pos_pk_post_and_diag_match_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, pl = setup_pk(p, dt, cuda, seed=10 + p)
    mops = kernels.modal_operators(basis, mesh, dtype=dt, device=cuda)
    for deg in (None, pl["deg"]):
        k, lam, minq = kernels.fused_modal_pos(u, mops, deg, with_diag=True)
        q, lam_p, minq_p = kernels.fused_modal_pos_plain(u, mops, deg,
                                                         with_diag=True)
        torch.cuda.synchronize()
        assert torch.equal(k, kernels.fused_modal_pos(u, mops, deg))
        e, flips = cell_flips(k, q, TOL[dt])
        assert e <= TOL[dt] and flips == 0
        assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]
    post = kernels.pk_post_operators(basis, mesh, beta=2.0, char_lim=True,
                                     dtype=dt, device=cuda)
    k, lam, minq = kernels.fused_pk_post(u, pl["shock"], post, with_diag=True)
    q, lam_p, minq_p = kernels.fused_pk_post_plain(u, pl["shock"], post,
                                                   with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(k, kernels.fused_pk_post(u, pl["shock"], post))
    e, flips = cell_flips(k, q, POST_TOL[dt])
    assert e <= POST_TOL[dt]
    assert flips <= (0 if dt == torch.float64 else PK_NX * PK_NY // 100)
    assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]
    diag = kernels.diag_operators(basis, mesh, dtype=dt, device=cuda)
    for a, b in zip(kernels.fused_diag(u, diag),
                    kernels.fused_diag_plain(u, diag)):
        assert same_bits(a, b)


@pytest.mark.parametrize("per", ((False, False), (True, True)))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (2, 3, 4, 5, 6))
def test_mood_check_is_bitwise_plain(cuda, p, dtype, per):
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, pl = setup_pk(p, dt, cuda, seed=20 + p)
    ops = kernels.mood_check_operators(basis, mesh, per_x=per[0],
                                       per_y=per[1], device=cuda)
    from dflo_tpu_torch.stab import mood
    rho0 = ops.avg0 * u[euler.RHO, 0]
    bmin = mood.neighborhood_min(rho0, ops.valid)
    bmax = mood.neighborhood_max(rho0, ops.valid)
    # a candidate near the predictor, so the DMP test goes both ways
    cand = (u * (1.0 + 1e-6 * torch.randn(u.shape, dtype=torch.float64,
                                          generator=torch.Generator()
                                          .manual_seed(p)).to(u))).contiguous()
    k = kernels.fused_mood_check(cand, bmin, bmax, pl["deg"], pl["lim"], ops)
    q = kernels.fused_mood_check_plain(cand, bmin, bmax, pl["deg"], pl["lim"],
                                       ops)
    torch.cuda.synchronize()
    for a, b in zip(k, q):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0 < int(k[2].sum()) < PK_NX * PK_NY       # both outcomes occur


# ---------------------------------------------------------------------------
# the forward-step kernels: the masked LxF residual, the masked post with the
# `limiter` indicator, the masked diag, and volume_residual
# ---------------------------------------------------------------------------

FS_NX, FS_NY = 90, 30      # the 3 x 1 box; ragged against every tile
INFLOW = (4.2, 0.0, 1.4, 8.8)


def fs_inflow(x, y, t):
    return torch.stack([torch.full_like(x, v) for v in INFLOW])


FS_BCS = dict(W=BoundarySide(euler.BC_INFLOW, fs_inflow),
              E=BoundarySide(euler.BC_OUTFLOW),
              S=BoundarySide(euler.BC_SLIP), N=BoundarySide(euler.BC_SLIP))


def setup_fs(p, dtype, device, seed=0):
    """The masked forward-step operators on Q_p and a perturbed inflow
    state (numpy seed), solid cells pinned, after the plain masked post."""
    basis = make_basis("Qk", p)
    mesh = CartesianMesh(FS_NX, FS_NY, 0.0, 3.0, 0.0, 1.0)
    xc, yc = mesh.cell_centers()
    mask = ~((xc > 0.6) & (yc < 0.2))
    rng = np.random.default_rng(seed)
    u = np.zeros((4, basis.K, FS_NY, FS_NX))
    u[0], u[1], u[2], u[3] = 4.2, 0.5, 1.4, 8.8
    u = u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    u = np.where(mask, u, np.array([0.0, 0.0, 1.0, 2.5])[:, None, None, None])
    post64 = kernels.post_operators(basis, mesh, indicator="limiter",
                                    beta=2.0, char_lim=True, pos_lim=True,
                                    mask=mask, dtype=torch.float64,
                                    device="cpu")
    u = kernels.fused_post_plain(torch.from_numpy(u), post64)
    post = kernels.post_operators(basis, mesh, indicator="limiter", beta=2.0,
                                  char_lim=True, pos_lim=True, mask=mask,
                                  dtype=dtype, device=device)
    rhs = make_rhs(basis, mesh, FS_BCS, flux="lxf", dtype=dtype,
                   device=device, volume_kernel="fused", mask=mask)
    diag = kernels.diag_operators(basis, mesh, mask=mask, dtype=dtype,
                                  device=device)
    return basis, mesh, u.to(dtype=dtype, device=device), rhs, post, diag


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2))
def test_masked_lxf_residual_matches_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, _, _ = setup_fs(p, dt, cuda, seed=30 + p)
    strips = rhs.strips(u, 0.0)
    before = kernels.fused_residual.launches
    R = kernels.fused_residual(u, *strips, rhs.ops)
    assert rel(R, kernels.fused_residual_plain(u, *strips, rhs.ops)) <= TOL[dt]
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-2).contiguous()
    S = kernels.fused_residual(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    Sp = kernels.fused_residual_plain(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    torch.cuda.synchronize()
    assert rel(S, Sp) <= TOL[dt]
    assert kernels.fused_residual.launches == before + 2
    assert float(R[..., ~rhs.ops.mask].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2))
def test_masked_post_and_diag_match_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, post, diag = setup_fs(p, dt, cuda, seed=40 + p)
    # one plain stage from the limited state, so the post has work to do
    u = kernels.fused_residual_plain(u, *rhs.strips(u, 0.0), rhs.ops,
                                     dt=torch.tensor(2e-3, dtype=dt,
                                                     device=cuda))
    k0 = kernels.fused_post(u, post)
    k, lam, minq = kernels.fused_post(u, post, with_diag=True)
    q, lam_p, minq_p = kernels.fused_post_plain(u, post, with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(k, k0)
    e, flips = cell_flips(k, q, POST_TOL[dt])
    assert e <= POST_TOL[dt]
    assert flips <= (0 if dt == torch.float64 else FS_NX * FS_NY // 100)
    assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]
    lam_d, minq_d = kernels.fused_diag(u, diag)
    for a, b in zip((lam_d, minq_d), kernels.fused_diag_plain(u, diag)):
        assert same_bits(a, b)
    # a NaN solid cell enters neither reduction; a NaN fluid cell trips
    # the fatal flag
    iy, ix = (~rhs.ops.mask).nonzero()[0].tolist()
    u_bad = u.clone()
    u_bad[:, :, iy, ix] = float("nan")
    lam_b, minq_b = kernels.fused_diag(u_bad, diag)
    assert same_bits(lam_b, lam_d) and same_bits(minq_b, minq_d)
    assert bool(minq_b >= EPS)
    u_bad[:, :, FS_NY - 1, 0] = float("nan")
    _, minq_b = kernels.fused_diag(u_bad, diag)
    _, _, minq_c = kernels.fused_post(u_bad, post, with_diag=True)
    assert bool(~(minq_b >= EPS)) and bool(~(minq_c >= EPS))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_volume_residual_matches_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, _, _, _ = setup_fs(p, dt, cuda, seed=50 + p)
    GxW = basis.wq2[:, None] * basis.Gx
    GyW = basis.wq2[:, None] * basis.Gy
    lift = torch.tensor(np.concatenate([mesh.dy * GxW.T, mesh.dx * GyW.T], 1),
                        dtype=dt, device=cuda).contiguous()
    before = kernels.volume_residual.launches
    k = kernels.volume_residual(lift, u)
    q = kernels.volume_residual_plain(lift, u)
    torch.cuda.synchronize()
    assert kernels.volume_residual.launches == before + 1
    assert same_bits(k, q)
    # the residual with the volume term through the kernel (the
    # volume_kernel="pallas" path) against the plain residual
    xc, yc = mesh.cell_centers()
    kw = dict(flux="lxf", dtype=dt, device=cuda,
              mask=~((xc > 0.6) & (yc < 0.2)))
    Rp = make_rhs(basis, mesh, FS_BCS, volume_kernel="pallas", **kw)(u, 0.0)
    Rx = make_rhs(basis, mesh, FS_BCS, volume_kernel="xla", **kw)(u, 0.0)
    torch.cuda.synchronize()
    assert rel(Rp, Rx) <= TOL[dt]



# ---------------------------------------------------------------------------
# the sharded RK path: the post's block form and the sharded diag
# ---------------------------------------------------------------------------

def _virtual_mesh(dev):
    from dflo_tpu_torch.parallel import device_mesh
    return device_mesh((2, 2), [dev] * 4)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_block_post_and_sharded_diag_match(cuda, p, dtype):
    """On NX x NY split into four 10 x 48 blocks: the block form against
    its plain block form (the single form's tolerances), the sharded post
    against the single-device post kernel (bitwise: the same neighbor
    numbers through the same operations) and the sharded diag equal to the
    single-device diag."""
    from dflo_tpu_torch.parallel import exchange_halos, gather_state
    from dflo_tpu_torch.parallel import shard_state
    dt = getattr(torch, dtype)
    u, post, _, diag = setup(p, dt, cuda)
    u = kernels.fused_post_plain(u, post)       # a limited state
    dm = _virtual_mesh(cuda)
    blocks = shard_state(u, dm)
    halos = exchange_halos(blocks, dm, post.per_x, post.per_y)
    before = kernels.fused_post.launches_block
    ks, qs = [], []
    for b, h in zip(blocks, halos):
        k, lam, mq = kernels.fused_post(b, post, True, halos=h)
        q, lam_p, mq_p = kernels.fused_post_plain(b, post, True, halos=h)
        ks.append(k)
        qs.append(q)
        assert rel(lam, lam_p) <= TOL[dt] and rel(mq, mq_p) <= TOL[dt]
    torch.cuda.synchronize()
    assert kernels.fused_post.launches_block == before + 4
    # scaled by the whole state's magnitudes (a block may hold a zero
    # component: the momenta ahead of the shock)
    err, flipped = cell_flips(gather_state(ks, dm), gather_state(qs, dm),
                              POST_TOL[dt])
    assert flipped <= (0 if dt == torch.float64 else NX * NY // 100)
    assert err <= POST_TOL[dt]
    outs, lam, mq = kernels.fused_post_sharded(blocks, [post] * 4, dm, True)
    k1, lam1, mq1 = kernels.fused_post(u, post, with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(gather_state(outs, dm), k1)
    assert torch.equal(lam, lam1) and torch.equal(mq, mq1)
    before = kernels.fused_diag_sharded.launches
    dk = kernels.fused_diag_sharded(blocks, [diag] * 4, dm)
    assert kernels.fused_diag_sharded.launches == before + 4
    assert all(torch.equal(a, b) for a, b in
               zip(dk, kernels.fused_diag(u, diag)))
    dp = kernels.fused_diag_sharded_plain(blocks, [diag] * 4, dm)
    assert all(same_bits(a, b) for a, b in zip(dk, dp))


def test_sharded_step_over_distinct_cards(cuda):
    """Three f64 steps of the DMR on a mesh over distinct cards against the
    single-device step (runs where two or more cards are visible)."""
    from dflo_tpu_torch import entry
    from dflo_tpu_torch.parallel import device_mesh
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    n = 4 if n >= 4 else 2
    dm = device_mesh((2, n // 2) if n == 4 else (1, 2),
                     [torch.device("cuda", i) for i in range(n)])
    s1, u0 = entry._build(NX, NY, dtype=torch.float64, device=cuda)
    sN, _ = entry._build(NX, NY, dtype=torch.float64, device=cuda,
                         device_mesh=dm)
    u = s1.post_stage(u0)
    b = sN.post_stage(sN.shard(u0))
    assert sorted({x.device.index for x in b}) == list(range(n))
    t = 0.0
    for _ in range(3):
        u, dt1, _, _ = s1._step(u, t, 1.0)
        b, dtN, bad, _ = sN._step(b, t, 1.0)
        t += float(dt1)
        assert abs(float(dtN) - float(dt1)) <= 1e-14 * float(dt1)
        assert not bool(bad)
    assert rel(sN.gather(b).to(u.device), u) <= 1e-10


# ---------------------------------------------------------------------------
# the modal LxF forms and the periodic Q1 post
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ny", (4, 10))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_modal_lxf_residual_matches_plain(cuda, p, dtype, ny):
    """The LxF residual on P_p in its R, u + dt*R and SSP-stage forms, each
    counted under its own form."""
    dt = getattr(torch, dtype)
    _, _, u, rhs, _ = setup_pk(p, dt, cuda, seed=p, ny=ny, flux="lxf")
    strips = rhs.strips(u, 0.0)
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for kw in ({}, {"dt": h}, {"u_old": u_old, "sc": sc}):
        k = kernels.fused_residual(u, *strips, rhs.ops, **kw)
        q = kernels.fused_residual_plain(u, *strips, rhs.ops, **kw)
        torch.cuda.synchronize()
        assert rel(k, q) <= TOL[dt], kw.keys()
    counts = kernels.launch_counts()
    assert all(counts[f"fused_residual[pk_lxf_{f}]"] == 1
               for f in ("R", "step", "stage")), counts


@pytest.mark.parametrize("ny", (4, 10))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (2, 3))
def test_lxf_candidate_is_bitwise_plain(cuda, p, dtype, ny):
    """The LxF candidate on a random cell set and on every cell, bitwise
    equal to its plain version (the averages of the tp'd states)."""
    dt = getattr(torch, dtype)
    _, _, u, rhs, pl = setup_pk(p, dt, cuda, seed=10 + p, ny=ny, flux="lxf")
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    tp_strips = rhs.strips(u, 0.0, pl["deg"])
    prev = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        k = kernels.fused_mood_candidate(u, prev.clone(), pl["deg"], cells,
                                         *tp_strips, rhs.ops, rhs.modal_ops,
                                         h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), pl["deg"],
                                               cells, *tp_strips, rhs.ops,
                                               rhs.modal_ops, h)
        torch.cuda.synchronize()
        assert torch.equal(k, q)
        assert torch.equal(k[..., ~cells], prev[..., ~cells])
    assert kernels.launch_counts()["fused_mood_candidate[lxf]"] == 2


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_periodic_q1_post_matches_plain(cuda, dtype):
    """The Q1 post periodic on both axes (vortex_system_pbc: the `limiter`
    indicator, characteristic TVB, no positivity) on the vortex system's
    IC with a 2 % perturbation (a numpy seed), with and without its
    diag."""
    dt = getattr(torch, dtype)
    basis = make_basis("Qk", 1)
    mesh = CartesianMesh(80, 44, -20.0, 20.0, -20.0, 20.0)
    rng = np.random.default_rng(7)
    u = ic.set_initial_condition(basis, mesh, ic.vortex_system(),
                                 dtype=torch.float64, device="cpu")
    u = (u * torch.from_numpy(1.0 + 0.02 * rng.uniform(-1.0, 1.0, u.shape))
         ).to(dtype=dt, device=cuda)
    post = kernels.post_operators(basis, mesh, indicator="limiter", beta=2.0,
                                  char_lim=True, pos_lim=False, per_x=True,
                                  per_y=True, dtype=dt, device=cuda)
    k0 = kernels.fused_post(u, post)
    k, lam, minq = kernels.fused_post(u, post, with_diag=True)
    pl, lam_p, minq_p = kernels.fused_post_plain(u, post, with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(k, k0)
    e, flips = cell_flips(k, pl, POST_TOL[dt])
    assert e <= POST_TOL[dt]
    assert flips <= (0 if dt == torch.float64 else 80 * 44 // 100)
    assert not torch.equal(pl, u)               # the limiter did act
    assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]


# ---------------------------------------------------------------------------
# the source arms of the residual: gravity, the force planes, isothermal
# well-balancing
# ---------------------------------------------------------------------------

SRC_NX, SRC_NY = 40, 10          # ragged against the 16-wide tiles
#: case -> (basis family, source arm, flux)
SRC_CASES = {"qk-grav-hllc": ("Qk", "grav", "hllc"),
             "pk-grav-lxf": ("Pk", "grav", "lxf"),
             "qk-force-lxf": ("Qk", "force", "lxf"),
             "pk-force-hllc": ("Pk", "force", "hllc"),
             "gll-grav-hllc": ("Qk_gll", "grav", "hllc"),
             "gll-wbiso-hllc": ("Qk_gll", "wbiso", "hllc"),
             "gll-wbiso-lxf": ("Qk_gll", "wbiso", "lxf"),
             "qk-wbiso-lxf": ("Qk", "wbiso", "lxf")}


def force_fn(x, y, t):
    return 0.3 * torch.sin(2.0 * np.pi * x) * torch.cos(t), -0.2 * y


def setup_src(family, arm, flux, p, dtype, device, nx=SRC_NX, ny=SRC_NY):
    """The fused rhs of a source arm on the unit square with outflow sides
    and the isothermal hydrostatic state with a 2 % perturbation (numpy
    seed p)."""
    basis = make_basis(family, p)
    mesh = CartesianMesh(nx, ny, 0.0, 1.0, 0.0, 1.0)
    u = ic.set_initial_condition(basis, mesh, ic.isothermal_hydrostatic(),
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(p)
    u = (u * torch.from_numpy(1.0 + 0.02 * rng.uniform(-1.0, 1.0, u.shape))
         ).to(dtype=dtype, device=device)
    out = BoundarySide(euler.BC_OUTFLOW)
    kw = {"grav": dict(source=euler.GravitySource(0.0, -1.21)),
          "force": dict(source=euler.ExternalForce(force_fn)),
          "wbiso": dict(well_balanced="isothermal",
                        potential=lambda x, y: x + y)}[arm]
    rhs = make_rhs(basis, mesh, dict(W=out, E=out, S=out, N=out), flux=flux,
                   dtype=dtype, device=device, volume_kernel="fused", **kw)
    return u, rhs


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
@pytest.mark.parametrize("case", sorted(SRC_CASES))
def test_source_residual_matches_plain(cuda, case, p, dtype):
    """Each source arm in the residual's R, u + dt*R and SSP-stage forms
    against its plain version, each counted under its own form."""
    family, arm, flux = SRC_CASES[case]
    dt = getattr(torch, dtype)
    u, rhs = setup_src(family, arm, flux, p, dt, cuda)
    t = torch.full((), 0.37, dtype=dt, device=cuda)
    strips, force = rhs.strips(u, t), rhs.force(t)
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for kw in ({}, {"dt": h}, {"u_old": u_old, "sc": sc}):
        k = kernels.fused_residual(u, *strips, rhs.ops, force=force, **kw)
        q = kernels.fused_residual_plain(u, *strips, rhs.ops, force=force,
                                         **kw)
        torch.cuda.synchronize()
        assert rel(k, q) <= TOL[dt], kw.keys()
    tag = {"Qk": "qk", "Pk": "pk", "Qk_gll": "gll"}[family]
    counts = kernels.launch_counts()
    assert all(counts[f"fused_residual[{tag}_{flux}_{arm}_{f}]"] == 1
               for f in ("R", "step", "stage")), counts


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_gll_diag_matches_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    u, _ = setup_src("Qk_gll", "wbiso", "lxf", p, dt, cuda)
    diag = kernels.diag_operators(make_basis("Qk_gll", p),
                                  CartesianMesh(SRC_NX, SRC_NY, 0.0, 1.0,
                                                0.0, 1.0),
                                  dtype=dt, device=cuda)
    lam, minq = kernels.fused_diag(u, diag)
    lam_p, minq_p = kernels.fused_diag_plain(u, diag)
    assert same_bits(lam, lam_p) and same_bits(minq, minq_p)


@pytest.mark.parametrize("flux", ("hllc", "lxf"))
def test_well_balance_through_the_kernel(cuda, flux):
    """The isothermal hydrostatic state on GLL2 at 64 x 64, 25 f64 steps
    through the fused residual kernel: drift below 5e-13
    (tests/test_gravity.py's oracle)."""
    from dflo_tpu_torch.driver import Solver
    basis = make_basis("Qk_gll", 2)
    mesh = CartesianMesh(64, 64, 0.0, 1.0, 0.0, 1.0)
    out = BoundarySide(euler.BC_OUTFLOW)
    s = Solver(basis, mesh, dict(W=out, E=out, S=out, N=out), flux=flux,
               cfl=0.5, dtype=torch.float64, device=cuda,
               well_balanced="isothermal", potential=lambda x, y: x + y)
    u0 = ic.set_initial_condition(basis, mesh, ic.isothermal_hydrostatic(),
                                  dtype=torch.float64, device=cuda)
    kernels.reset_launch_counts()
    u, t, n, bad, _ = s._multi_step(25)(s.post_stage(u0), 0.0, 1e9)
    assert int(n) == 25 and not bool(bad)
    assert kernels.launch_counts()[f"fused_residual[gll_{flux}_wbiso_stage]"] \
        == 75
    drift = float((u - u0).abs().max())
    assert drift < 5e-13, drift


# ---------------------------------------------------------------------------
# the Roe, Steger-Warming, KFVS and KEP forms of the residual, and one
# implicit step with the kernel primal against the plain primal
# ---------------------------------------------------------------------------

NEW_FLUXES = ("roe", "sw", "kfvs", "kep")


def bump_state(x, y, t=0.0):
    """Free stream (0.5, 0, 1, 2.6) with a Gaussian bump
    (tests/test_implicit.py:83-110)."""
    b = 0.05 * torch.exp(-50.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    return torch.stack([0.5 + b, b, 1.0 + b, torch.full_like(x, 2.6)])


def far_values(x, y, t):
    return torch.stack([torch.full_like(x, v) for v in (0.5, 0.0, 1.0, 2.6)])


BUMP_BCS = dict(W=BoundarySide(euler.BC_FARFIELD, far_values),
                E=BoundarySide(euler.BC_FARFIELD, far_values),
                S=BoundarySide(euler.BC_SLIP), N=BoundarySide(euler.BC_SLIP))


def setup_bump(family, p, flux, dtype, device, nx=SRC_NX, ny=SRC_NY,
               nq=None, mask=None):
    """The fused rhs of `flux` on the unit square (farfield W/E, slip S/N)
    and the bump state with a 2 % perturbation (numpy seed p); nq
    quadrature points per direction (None: p + 1), a solid-cell mask."""
    basis = make_basis(family, p, nq)
    mesh = CartesianMesh(nx, ny, 0.0, 1.0, 0.0, 1.0)
    u = ic.set_initial_condition(basis, mesh, bump_state,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(p)
    u = (u * torch.from_numpy(1.0 + 0.02 * rng.uniform(-1.0, 1.0, u.shape))
         ).to(dtype=dtype, device=device)
    rhs = make_rhs(basis, mesh, BUMP_BCS, flux=flux, dtype=dtype,
                   device=device, volume_kernel="fused",
                   mask=None if mask is None else mask(mesh))
    return u, rhs


def check_three_forms(cuda, u, rhs, dt, tag):
    """R, u + dt*R and the SSP stage against the plain version, each
    launched once under its own form key."""
    t = torch.full((), 0.25, dtype=dt, device=cuda)
    strips = rhs.strips(u, t)
    h = torch.full((), 1e-3, dtype=dt, device=cuda)
    sc = torch.tensor([0.75, 1e-3], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for kw in ({}, {"dt": h}, {"u_old": u_old, "sc": sc}):
        k = kernels.fused_residual(u, *strips, rhs.ops, **kw)
        q = kernels.fused_residual_plain(u, *strips, rhs.ops, **kw)
        torch.cuda.synchronize()
        assert rel(k, q) <= TOL[dt], kw.keys()
    counts = kernels.launch_counts()
    assert all(counts[f"fused_residual[{tag}_{f}]"] == 1
               for f in ("R", "step", "stage")), counts


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2))
@pytest.mark.parametrize("family", ("Qk", "Qk_gll", "Pk"))
@pytest.mark.parametrize("flux", NEW_FLUXES)
def test_new_flux_residual_matches_plain(cuda, flux, family, p, dtype):
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda)
    tag = {"Qk": "qk", "Pk": "pk", "Qk_gll": "gll"}[family]
    check_three_forms(cuda, u, rhs, dt, f"{tag}_{flux}")


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("flux", NEW_FLUXES)
def test_new_flux_masked_residual_matches_plain(cuda, flux, dtype):
    dt = getattr(torch, dtype)
    basis, mesh, u, _, _, _ = setup_fs(1, dt, cuda, seed=40)
    rhs = make_rhs(basis, mesh, FS_BCS, flux=flux, dtype=dt, device=cuda,
                   volume_kernel="fused", mask=mesh_mask(mesh))
    check_three_forms(cuda, u, rhs, dt, f"qk_{flux}_masked")


def mesh_mask(mesh):
    """The forward step's solid block of setup_fs."""
    xc, yc = mesh.cell_centers()
    return ~((xc > 0.6) & (yc < 0.2))


def test_new_fluxes_refuse_mood_and_source_arms(cuda):
    u, rhs = setup_bump("Pk", 2, "roe", torch.float64, cuda)
    basis = make_basis("Qk", 1)
    mesh = CartesianMesh(SRC_NX, SRC_NY, 0.0, 1.0, 0.0, 1.0)
    # the source arms take the new fluxes (test_new_flux_source_arm_matches_
    # plain): kep with gravity builds its kernel form on the card
    grav = make_rhs(basis, mesh, BUMP_BCS, flux="kep", dtype=torch.float64,
                    device=cuda, volume_kernel="fused",
                    source=euler.GravitySource(0.0, -1.0))
    assert (grav.ops.flux, grav.ops.source) == ("kep", "grav")
    # the candidate takes roe (test_mood_candidate_new_fluxes_bitwise);
    # a masked residual has none, and its operators refuse the kernel
    deg = torch.full(u.shape[2:], 2, dtype=torch.int32, device=cuda)
    cells = torch.ones(u.shape[2:], dtype=torch.bool, device=cuda)
    masked = kernels.residual_operators(
        make_basis("Pk", 2), CartesianMesh(u.shape[3], u.shape[2], 0.0, 1.0,
                                           0.0, 1.0),
        flux="roe", mask=np.ones(u.shape[2:], bool), dtype=u.dtype,
        device=cuda)
    strips = rhs.strips(u, 0.0, deg)
    with pytest.raises(ValueError, match="no mask"):
        kernels.fused_mood_candidate(
            u, u.clone(), deg, cells, *strips, masked, rhs.modal_ops,
            torch.full((), 1e-3, dtype=u.dtype, device=cuda))


def test_implicit_step_kernel_primal_matches_plain_primal(cuda):
    """One f64 implicit step (Q1, roe, block-Jacobi, two Newton
    iterations) with the residual kernel's primal against the plain
    residual's: the same state to 1e-10 and the same Newton count, the
    kernel launched in its R form, no plain twin called."""
    from dflo_tpu_torch.driver import Solver
    basis = make_basis("Qk", 1)
    mesh = CartesianMesh(24, 16, 0.0, 1.0, 0.0, 1.0)
    out = {}
    for vk in ("fused", "xla"):
        s = Solver(basis, mesh, BUMP_BCS, flux="roe", cfl=5.0,
                   method="implicit", max_nonlin_iter=2,
                   linear_residual=1e-6, precondition="block_jacobi",
                   volume_kernel=vk, dtype=torch.float64, device=cuda)
        u0 = ic.set_initial_condition(basis, mesh, bump_state,
                                      dtype=torch.float64, device=cuda)
        kernels.reset_launch_counts()
        u, dt, bad, info, _ = s._step(u0, 0.0, 1.0, pred=u0)
        torch.cuda.synchronize()
        assert not bool(bad)
        # the linear solves converged and Newton reduced ||F||
        assert float(info.lin_res) <= 1.001e-6
        assert float(info.res) < float(info.res0)
        out[vk] = (u, int(info.iters), kernels.launch_counts())
    assert rel(out["fused"][0], out["xla"][0]) <= 1e-10
    assert out["fused"][1] == out["xla"][1]
    assert out["fused"][2]["fused_residual[qk_roe_R]"] > 0
    assert out["xla"][2]["fused_residual"] == 0


# ---------------------------------------------------------------------------
# masked modal Pk, the candidate with every flux, masked and gravity MOOD
# ---------------------------------------------------------------------------

ALL_FLUXES = ("hllc", "lxf") + NEW_FLUXES


def setup_fs_pk(p, flux, dtype, device, seed=0):
    """The masked forward-step residual on P_p and a perturbed modal inflow
    state (numpy seed: 2 % on mode 0, 0.3 % of it on the higher modes),
    solid cells at the benign state as a constant."""
    basis = make_basis("Pk", p)
    mesh = CartesianMesh(FS_NX, FS_NY, 0.0, 3.0, 0.0, 1.0)
    mask = mesh_mask(mesh)
    rng = np.random.default_rng(seed)
    base = np.array(INFLOW)[:, None, None, None]
    u = np.zeros((4, basis.K, FS_NY, FS_NX))
    u[:, :1] = base * (1.0 + 0.02 * rng.uniform(-1.0, 1.0,
                                                (4, 1, FS_NY, FS_NX)))
    u[:, 1:] = 0.003 * base * rng.uniform(-1.0, 1.0,
                                          (4, basis.K - 1, FS_NY, FS_NX))
    u[1, 1:] = 0.01 * rng.uniform(-1.0, 1.0, (basis.K - 1, FS_NY, FS_NX))
    solid = np.zeros((4, basis.K, 1, 1))
    solid[:, 0, 0, 0] = 0.0, 0.0, 1.0, 2.5
    u = np.where(mask, u, solid)
    rhs = make_rhs(basis, mesh, FS_BCS, flux=flux, dtype=dtype,
                   device=device, volume_kernel="fused", mask=mask)
    return torch.from_numpy(u).to(dtype=dtype, device=device), rhs


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3))
@pytest.mark.parametrize("flux", ALL_FLUXES)
def test_masked_modal_residual_matches_plain(cuda, flux, p, dtype):
    dt = getattr(torch, dtype)
    u, rhs = setup_fs_pk(p, flux, dt, cuda, seed=50 + p)
    assert not hasattr(rhs, "sparse_candidate")
    check_three_forms(cuda, u, rhs, dt, f"pk_{flux}_masked")
    strips = rhs.strips(u, 0.25)
    R = kernels.fused_residual(u, *strips, rhs.ops)
    torch.cuda.synchronize()
    assert float(R[..., ~rhs.ops.mask].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (2, 3))
@pytest.mark.parametrize("flux", NEW_FLUXES)
def test_mood_candidate_new_fluxes_bitwise(cuda, flux, p, dtype):
    """The candidate with each new flux on a random cell set and on every
    cell, bitwise equal to its plain version."""
    dt = getattr(torch, dtype)
    _, _, u, rhs, pl = setup_pk(p, dt, cuda, seed=20 + p, flux=flux)
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    tp_strips = rhs.strips(u, 0.0, pl["deg"])
    prev = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        k = kernels.fused_mood_candidate(u, prev.clone(), pl["deg"], cells,
                                         *tp_strips, rhs.ops, rhs.modal_ops,
                                         h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), pl["deg"],
                                               cells, *tp_strips, rhs.ops,
                                               rhs.modal_ops, h)
        torch.cuda.synchronize()
        assert torch.equal(k, q)
        assert torch.equal(k[..., ~cells], prev[..., ~cells])
    assert kernels.launch_counts()[f"fused_mood_candidate[{flux}]"] == 2


def _plain_wrappers():
    """Every kernel wrapper of the MOOD step replaced by its plain
    version (restored by the caller)."""
    names = ("fused_residual", "fused_mood_candidate", "fused_modal_pos",
             "fused_pk_post", "fused_mood_check", "fused_diag")
    saved = {n: getattr(kernels, n) for n in names}
    for n in names:
        setattr(kernels, n, getattr(kernels, n + "_plain"))
    return saved


@pytest.mark.parametrize("case", ("masked", "gravity", "p4", "p1",
                                  "p4_masked", "p4_gravity"))
def test_mood_steps_match_plain(cuda, case):
    """Three f64 MOOD steps through the kernels against the same steps
    through the plain versions on the card: on P2 (and P4) the masked
    forward step (the dense route, the plain masked check, the modal
    positivity kernel and the masked diag) and the DMR with a GravitySource
    (the dense route on the gravity arm, the check kernel, the Pk post);
    the DMR box from the contact on P4 (the sparse route on the general
    candidate, the check kernel, the general modal positivity and Pk post)
    and on P1 (the plain check with the u2 test off, the P1 kernels)."""
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    from dflo_tpu_torch.entry import contact_ic
    lim = LimiterConfig(type="TVB", shock_indicator="limiter", beta=2.0,
                        char_lim=True, pos_lim=True)
    p = 4 if case.startswith("p4") else 1 if case == "p1" else 2
    basis = make_basis("Pk", p)
    if case in ("p4", "p1"):
        mesh = CartesianMesh(PK_NX, PK_NY, 0.0, 4.0, 0.0, 1.0)
        kw = dict(flux="hllc")
        bcs, fn = BCS, contact_ic
        # on P1 no degree can drop, so every cascade ends after pass 1 (as
        # the reference's: dflo_tpu/stab/mood.py:357-361): no candidate,
        # no modal positivity, and the check is the plain one
        forms = ("fused_residual[pk_hllc_step]", "fused_pk_post")
        if case == "p4":
            forms += ("fused_mood_candidate[hllc]", "fused_modal_pos",
                      "fused_mood_check")
    elif case.endswith("masked"):
        mesh = CartesianMesh(FS_NX, FS_NY, 0.0, 3.0, 0.0, 1.0)
        kw = dict(flux="lxf", mask=mesh_mask(mesh))
        bcs, fn = FS_BCS, fs_inflow
        forms = ("fused_residual[pk_lxf_masked_step]", "fused_modal_pos",
                 "fused_diag")
    else:
        mesh = CartesianMesh(PK_NX, PK_NY, 0.0, 4.0, 0.0, 1.0)
        kw = dict(flux="hllc", source=euler.GravitySource(0.0, -1.0))
        bcs, fn = BCS, dmr_ic
        forms = ("fused_residual[pk_hllc_grav_step]", "fused_mood_check",
                 "fused_pk_post", "fused_modal_pos")
    s = Solver(basis, mesh, bcs, limiter=lim, cfl=0.5, dtype=torch.float64,
               device=cuda, method="mood", **kw)
    u0 = s.post_stage(s.apply_mask(ic.set_initial_condition(
        basis, mesh, fn, dtype=torch.float64, device=cuda)))
    out = []
    for plain in (False, True):
        saved = _plain_wrappers() if plain else {}
        try:
            kernels.reset_launch_counts()
            u, t, stats = u0, 0.0, []
            for _ in range(3):
                u, dt, bad, st = s._step(u, t, 1.0)
                t += float(dt)
                assert not bool(bad)
                stats.append((int(st.n_reduce), int(st.n_marked), st.iters))
            out.append((u, t, stats, kernels.launch_counts()))
        finally:
            for n, f in saved.items():
                setattr(kernels, n, f)
    (uk, tk, sk, ck), (up, tp, sp, _) = out
    assert rel(uk, up) <= 1e-10 and abs(tk - tp) <= 1e-13 * tp
    assert sk == sp
    # the cascade fired: degrees dropped (on P1: cells marked instead)
    assert sum(r[1 if case == "p1" else 0] for r in sk) > 0
    assert all(ck.get(f, 0) > 0 for f in forms), ck
    if case == "p1":
        assert ck["fused_mood_check"] == ck["fused_mood_candidate"] == \
            ck["fused_modal_pos"] == 0


# ---------------------------------------------------------------------------
# the envelope: degrees 4-6, over-integrated quadrature, the source arms
# with roe, sw, kfvs and kep
# ---------------------------------------------------------------------------

TAGS = {"Qk": "qk", "Pk": "pk", "Qk_gll": "gll"}


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (4, 5, 6))
@pytest.mark.parametrize("family", ("Qk", "Qk_gll", "Pk"))
@pytest.mark.parametrize("flux", ALL_FLUXES)
def test_high_degree_residual_matches_plain(cuda, flux, family, p, dtype):
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda)
    check_three_forms(cuda, u, rhs, dt, f"{TAGS[family]}_{flux}")


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("case", (("Qk", 2, 4), ("Qk_gll", 2, 4),
                                  ("Pk", 2, 4), ("Qk", 4, 6), ("Qk", 6, 8),
                                  ("Pk", 6, 8)))
@pytest.mark.parametrize("flux", ("lxf", "roe", "kep"))
def test_over_integrated_residual_matches_plain(cuda, flux, case, dtype):
    """A basis off its default quadrature (nq = p + 2): the kernel's
    general dims contract the DoFs with V, as the modal basis does."""
    family, p, nq = case
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda, nq=nq)
    assert rhs.ops.V is not None and rhs.ops.nq == nq
    check_three_forms(cuda, u, rhs, dt, f"{TAGS[family]}_{flux}")


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("case", (("Qk", 4, None, "lxf"),
                                  ("Qk_gll", 5, None, "kep"),
                                  ("Pk", 4, None, "roe"),
                                  ("Qk", 2, 4, "hllc")))
def test_high_degree_masked_residual_matches_plain(cuda, case, dtype):
    family, p, nq, flux = case
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda, nq=nq, mask=mesh_mask)
    check_three_forms(cuda, u, rhs, dt, f"{TAGS[family]}_{flux}_masked")
    R = kernels.fused_residual(u, *rhs.strips(u, 0.0), rhs.ops)
    assert float(R[..., ~rhs.ops.mask].abs().max()) == 0.0


#: case -> (basis family, source arm); with each new flux
NEW_SRC_CASES = {"qk-grav": ("Qk", "grav"), "pk-force": ("Pk", "force"),
                 "gll-wbiso": ("Qk_gll", "wbiso"), "pk-grav": ("Pk", "grav")}


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("case", sorted(NEW_SRC_CASES))
@pytest.mark.parametrize("flux", NEW_FLUXES)
def test_new_flux_source_arm_matches_plain(cuda, flux, case, p, dtype):
    """The twelve (flux, arm) pairs the kernel gained, in the R, u + dt*R
    and SSP-stage forms, each counted under its own form; p = 4 runs the
    general dims."""
    family, arm = NEW_SRC_CASES[case]
    dt = getattr(torch, dtype)
    u, rhs = setup_src(family, arm, flux, p, dt, cuda)
    t = torch.full((), 0.37, dtype=dt, device=cuda)
    strips, force = rhs.strips(u, t), rhs.force(t)
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    kernels.reset_launch_counts()
    for kw in ({}, {"dt": h}, {"u_old": u_old, "sc": sc}):
        k = kernels.fused_residual(u, *strips, rhs.ops, force=force, **kw)
        q = kernels.fused_residual_plain(u, *strips, rhs.ops, force=force,
                                         **kw)
        torch.cuda.synchronize()
        assert rel(k, q) <= TOL[dt], kw.keys()
    counts = kernels.launch_counts()
    assert all(counts[f"fused_residual[{TAGS[family]}_{flux}_{arm}_{f}]"]
               == 1 for f in ("R", "step", "stage")), counts


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("p", (4, 5, 6))
def test_high_degree_post_matches_plain(cuda, p, masked, dtype):
    """The post on Q4-Q6 (the general dims), masked and not, with and
    without its diag."""
    dt = getattr(torch, dtype)
    u, post, _, _ = setup(p, dt, cuda)
    if masked:
        post = kernels.post_operators(
            make_basis("Qk", p), CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0),
            indicator="density", beta=2.0, char_lim=True, pos_lim=True,
            mask=mesh_mask(CartesianMesh(NX, NY, 0.0, 1.0, 0.0, 1.0)),
            dtype=dt, device=cuda)
    k0 = kernels.fused_post(u, post)
    k, lam, minq = kernels.fused_post(u, post, with_diag=True)
    pl, lam_p, minq_p = kernels.fused_post_plain(u, post, with_diag=True)
    torch.cuda.synchronize()
    assert torch.equal(k, k0)
    err, flipped = cell_flips(k, pl, POST_TOL[dt])
    assert flipped <= (0 if dt == torch.float64 else NX * NY // 100)
    assert err <= POST_TOL[dt]
    assert rel(lam, lam_p) <= TOL[dt] and rel(minq, minq_p) <= TOL[dt]


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("case", (("Qk", 4, None), ("Qk", 6, 8),
                                  ("Qk_gll", 5, 7), ("Pk", 4, None),
                                  ("Pk", 6, 8), ("Qk", 2, 4)))
def test_envelope_diag_matches_plain(cuda, case, dtype):
    family, p, nq = case
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, "lxf", dt, cuda, nq=nq)
    mesh = CartesianMesh(SRC_NX, SRC_NY, 0.0, 1.0, 0.0, 1.0)
    for mask in (None, mesh_mask(mesh)):
        diag = kernels.diag_operators(make_basis(family, p, nq), mesh,
                                      mask=mask, dtype=dt, device=cuda)
        before = kernels.fused_diag.launches
        lam, minq = kernels.fused_diag(u, diag)
        lam_p, minq_p = kernels.fused_diag_plain(u, diag)
        assert same_bits(lam, lam_p) and same_bits(minq, minq_p)
        assert kernels.fused_diag.launches == before + 1


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (4, 5, 6))
def test_volume_residual_q4_q6_matches_plain(cuda, p, dtype):
    dt = getattr(torch, dtype)
    u, _, _, _ = setup(p, dt, cuda)
    rhs = make_rhs(make_basis("Qk", p), CartesianMesh(NX, NY, 0.0, 4.0, 0.0,
                                                      1.0),
                   BCS, dtype=dt, device=cuda, volume_kernel="pallas")
    before = kernels.volume_residual.launches
    k = kernels.volume_residual(rhs.lift_stack, u)
    q = kernels.volume_residual_plain(rhs.lift_stack, u)
    torch.cuda.synchronize()
    assert same_bits(k, q)
    assert kernels.volume_residual.launches == before + 1


def test_mood_above_p3_and_quadrature_beyond_cap_raise(cuda):
    """MOOD above the kernels' degrees (p = 7) and a basis beyond NQ_MAX
    raise at Solver construction on the card too; MOOD at p 4-6 builds
    there, with its check kernel's operators."""
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    mesh = CartesianMesh(SRC_NX, SRC_NY, 0.0, 1.0, 0.0, 1.0)
    lim = LimiterConfig(type="TVB", beta=2.0, pos_lim=True)
    with pytest.raises(NotImplementedError,
                       match="the bounds of the general dims"):
        Solver(make_basis("Pk", 7), mesh, BUMP_BCS, limiter=lim,
               dtype=torch.float32, device=cuda, method="mood")
    with pytest.raises(NotImplementedError,
                       match="the bounds of the general dims"):
        Solver(make_basis("Qk", 2, kernels.NQ_MAX + 1), mesh, BUMP_BCS,
               dtype=torch.float32, device=cuda)
    for p in (4, 5, 6):
        s = Solver(make_basis("Pk", p), mesh, BUMP_BCS, limiter=lim,
                   dtype=torch.float32, device=cuda, method="mood")
        assert s._mood_stage.cops.p == p and s._mood_stage.sparse


# ---------------------------------------------------------------------------
# the MOOD kernels over the whole degree range: the candidate (every flux,
# and the over-integrated P2), the modal positivity, the Pk post and the
# check at p 4-6, each bitwise equal to its plain version
# ---------------------------------------------------------------------------

def candidate_pairs(u, rhs, pl, dt, cuda):
    """(kernel, plain, cells) of the candidate on a random cell set and on
    every cell, with the launches counted."""
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    tp_strips = rhs.strips(u, 0.0, pl["deg"])
    prev = u.flip(-1).contiguous()
    out = []
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        k = kernels.fused_mood_candidate(u, prev.clone(), pl["deg"], cells,
                                         *tp_strips, rhs.ops, rhs.modal_ops,
                                         h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), pl["deg"],
                                               cells, *tp_strips, rhs.ops,
                                               rhs.modal_ops, h)
        out.append((k, q, cells, prev))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (4, 5, 6))
@pytest.mark.parametrize("flux", ALL_FLUXES)
def test_high_degree_mood_candidate_is_bitwise_plain(cuda, flux, p, dtype):
    """The general candidate (csrc/candidate.cuh, GDims) at p 4-6 with
    every flux, on a random cell set and on every cell, bitwise equal to
    its plain version; cells off the set keep u_prev."""
    dt = getattr(torch, dtype)
    _, _, u, rhs, pl = setup_pk(p, dt, cuda, seed=40 + p, flux=flux)
    kernels.reset_launch_counts()
    for k, q, cells, prev in candidate_pairs(u, rhs, pl, dt, cuda):
        assert torch.equal(k.nan_to_num(), q.nan_to_num())
        assert torch.equal(k.isnan(), q.isnan())
        assert torch.equal(k[..., ~cells], prev[..., ~cells])
    assert kernels.launch_counts()[f"fused_mood_candidate[{flux}]"] == 2


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("flux", ("hllc", "lxf"))
def test_over_integrated_mood_candidate_is_bitwise_plain(cuda, flux, dtype):
    """The candidate on P2 with 4 x 4 quadrature points: its operator
    buffer and strips are laid out for nq = 4, so the wrapper passes K, nq
    and the positivity points and the launch table takes the general
    candidate (the P2 instantiation assumes nq = 3).  Bitwise equal to its
    plain version."""
    dt = getattr(torch, dtype)
    _, _, u, rhs, pl = setup_pk(2, dt, cuda, seed=47, flux=flux, nq=4)
    assert (rhs.ops.p, rhs.ops.nq, rhs.ops.K) == (2, 4, 6)
    for k, q, cells, prev in candidate_pairs(u, rhs, pl, dt, cuda):
        assert torch.equal(k, q)
        assert torch.equal(k[..., ~cells], prev[..., ~cells])


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (4, 5, 6))
def test_high_degree_modal_pos_and_pk_post_are_bitwise_plain(cuda, p,
                                                             dtype):
    """The modal positivity in its four forms and the Pk post with and
    without its diag at p 4-6 (the general modal dims), bitwise equal to
    their plain versions."""
    dt = getattr(torch, dtype)
    basis, mesh, u, rhs, pl = setup_pk(p, dt, cuda, seed=50 + p)
    mops = rhs.modal_ops
    kernels.reset_launch_counts()
    for deg in (None, pl["deg"]):
        k = kernels.fused_modal_pos(u, mops, deg, with_diag=True)
        q = kernels.fused_modal_pos_plain(u, mops, deg, with_diag=True)
        k0 = kernels.fused_modal_pos(u, mops, deg)
        torch.cuda.synchronize()
        assert torch.equal(k0, q[0])
        assert all(torch.equal(a, b) for a, b in zip(k, q))
    post = kernels.pk_post_operators(basis, mesh, beta=2.0, char_lim=True,
                                     dtype=dt, device=cuda)
    k = kernels.fused_pk_post(u, pl["shock"], post, with_diag=True)
    q = kernels.fused_pk_post_plain(u, pl["shock"], post, with_diag=True)
    k0 = kernels.fused_pk_post(u, pl["shock"], post)
    torch.cuda.synchronize()
    assert torch.equal(k0, q[0])
    assert all(torch.equal(a, b) for a, b in zip(k, q))
    counts = kernels.launch_counts()
    assert counts["fused_modal_pos"] == 4 and counts["fused_pk_post"] == 2


# ---------------------------------------------------------------------------
# the tile kernels' edges (csrc/residual.cuh, kernels.residual_tile): tiles
# cut by the grid's edge, grids smaller than one tile, the wrap faces on
# both sides, solid cells on tile and domain edges, every basis kind and
# source arm, and the candidate over its tile list; each bitwise equal to
# its plain version
# ---------------------------------------------------------------------------

#: (nx, ny): ragged against every tile (4, 8 and 16 wide), and smaller than
#: one tile on either axis
TILE_GRIDS = ((37, 11), (3, 2), (1, 5), (2, 1), (19, 3))
#: (family, p, nq or None, flux): P1, P2, P4, P6, Q2, Q5, GLL3 and the
#: over-integrated Q2 and P2 (4 x 4 points)
TILE_BASES = (("Pk", 1, None, "hllc"), ("Pk", 2, None, "lxf"),
              ("Pk", 4, None, "kep"), ("Pk", 6, None, "roe"),
              ("Qk", 2, None, "hllc"), ("Qk", 5, None, "sw"),
              ("Qk_gll", 3, None, "kfvs"), ("Qk", 2, 4, "lxf"),
              ("Pk", 2, 4, "hllc"))
PERIODIC = {side: BoundarySide(euler.BC_PERIODIC) for side in "WESN"}


def same_bits(k, q) -> bool:
    return (torch.equal(k.nan_to_num(), q.nan_to_num())
            and torch.equal(k.isnan(), q.isnan()))


def forms_bitwise(cuda, u, rhs, dt, t=0.25):
    """R, u + dt*R and the SSP stage, each bitwise equal to the plain
    version (an external force with its planes at t)."""
    t = torch.full((), t, dtype=dt, device=cuda)
    strips = rhs.strips(u, t)
    force = rhs.force(t) if rhs.ops.source == "force" else None
    h = torch.full((), 1e-3, dtype=dt, device=cuda)
    sc = torch.tensor([0.75, 1e-3], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    for kw in ({}, {"dt": h}, {"u_old": u_old, "sc": sc}):
        k = kernels.fused_residual(u, *strips, rhs.ops, force=force, **kw)
        q = kernels.fused_residual_plain(u, *strips, rhs.ops, force=force,
                                         **kw)
        torch.cuda.synchronize()
        assert same_bits(k, q), (kw.keys(), rel(k, q))


def edge_mask(mesh):
    """Solid cells on the domain's four edges and on the tiles' edges
    (columns 7, 8, 15, 16 and rows 3, 4, 7, 8), fluid elsewhere."""
    m = np.ones((mesh.ny, mesh.nx), bool)
    m[::3, 0] = m[1::4, -1] = False
    m[0, 1::5] = m[-1, ::4] = False
    for x in (7, 8, 15, 16):
        if x < mesh.nx:
            m[1::2, x] = False
    for y in (3, 4, 7, 8):
        if y < mesh.ny:
            m[y, 2::3] = False
    return m


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", TILE_GRIDS)
@pytest.mark.parametrize("case", TILE_BASES)
def test_tile_edges_residual_is_bitwise_plain(cuda, case, grid, dtype):
    """The three forms on grids cut against the tile and smaller than one,
    with the bump's farfield and slip strips on the wrap faces."""
    family, p, nq, flux = case
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda, nx=grid[0], ny=grid[1],
                        nq=nq)
    forms_bitwise(cuda, u, rhs, dt)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", ((37, 11), (2, 3)))
@pytest.mark.parametrize("case", TILE_BASES)
def test_tile_edges_periodic_residual_is_bitwise_plain(cuda, case, grid,
                                                       dtype):
    """Periodic on both axes: the wrap faces carry the flux between the
    first and the last column (row) with no strip."""
    family, p, nq, flux = case
    dt = getattr(torch, dtype)
    basis = make_basis(family, p, nq)
    mesh = CartesianMesh(grid[0], grid[1], 0.0, 1.0, 0.0, 1.0)
    u, _ = setup_bump(family, p, flux, dt, cuda, nx=grid[0], ny=grid[1],
                      nq=nq)
    rhs = make_rhs(basis, mesh, PERIODIC, flux=flux, dtype=dt, device=cuda,
                   volume_kernel="fused")
    forms_bitwise(cuda, u, rhs, dt)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", ((37, 11), (17, 9), (3, 2)))
@pytest.mark.parametrize("case", (("Qk", 1, None, "lxf"),
                                  ("Pk", 2, None, "hllc"),
                                  ("Pk", 4, None, "kep"),
                                  ("Qk_gll", 2, None, "roe"),
                                  ("Qk", 2, 4, "sw")))
def test_tile_edges_masked_residual_is_bitwise_plain(cuda, case, grid,
                                                     dtype):
    """Solid cells on the domain's edges and on the tiles' edges: the
    slip-wall mirror per face, the wrap faces included; a solid cell's R
    exactly 0."""
    family, p, nq, flux = case
    dt = getattr(torch, dtype)
    u, rhs = setup_bump(family, p, flux, dt, cuda, nx=grid[0], ny=grid[1],
                        nq=nq, mask=edge_mask)
    forms_bitwise(cuda, u, rhs, dt)
    R = kernels.fused_residual(u, *rhs.strips(u, 0.0), rhs.ops)
    torch.cuda.synchronize()
    assert bool((R[..., ~rhs.ops.mask] == 0).all())


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", ((37, 11), (3, 2)))
@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("case", sorted(SRC_CASES))
def test_tile_edges_source_arm_is_bitwise_plain(cuda, case, p, grid, dtype):
    """Every source arm (gravity, the force planes, isothermal
    well-balancing) on tiles cut by the grid's edge."""
    family, arm, flux = SRC_CASES[case]
    dt = getattr(torch, dtype)
    u, rhs = setup_src(family, arm, flux, p, dt, cuda, nx=grid[0],
                       ny=grid[1])
    forms_bitwise(cuda, u, rhs, dt, t=0.37)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", ((37, 11), (3, 2), (96, 24)))
@pytest.mark.parametrize("case", ((1, None, "hllc"), (2, None, "lxf"),
                                  (4, None, "kep"), (6, None, "roe"),
                                  (2, 4, "sw")))
def test_tile_edges_candidate_is_bitwise_plain(cuda, case, grid, dtype):
    """The candidate over its tile list: set cells at the four corners
    (the wrap faces' tiles), an empty set (the output is u_prev: no tile
    launches work) and a full set (the dense candidate u_t + dt*R(u_t))."""
    p, nq, flux = case
    dt = getattr(torch, dtype)
    _, _, u, rhs, pl = setup_pk(p, dt, cuda, seed=60 + p, ny=grid[1],
                                flux=flux, nq=nq, nx=grid[0])
    mops, deg = rhs.modal_ops, pl["deg"]
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    strips = rhs.strips(u, 0.0, deg)
    prev = u.flip(-1).contiguous()
    corners = torch.zeros_like(pl["cells"])
    corners[0, 0] = corners[0, -1] = corners[-1, 0] = corners[-1, -1] = True
    for cells in (corners, torch.zeros_like(corners)):
        k = kernels.fused_mood_candidate(u, prev.clone(), deg, cells,
                                         *strips, rhs.ops, mops, h)
        q = kernels.fused_mood_candidate_plain(u, prev.clone(), deg, cells,
                                               *strips, rhs.ops, mops, h)
        torch.cuda.synchronize()
        assert same_bits(k, q)
        assert torch.equal(k[..., ~cells], prev[..., ~cells])
    full = torch.ones_like(corners)
    k = kernels.fused_mood_candidate(u, prev.clone(), deg, full, *strips,
                                     rhs.ops, mops, h)
    dense = kernels.fused_residual_plain(kernels.modal_tp_plain(u, deg, mops),
                                         *strips, rhs.ops, dt=h)
    torch.cuda.synchronize()
    assert same_bits(k, dense)


@pytest.mark.parametrize("shape", ((288, 1152), (11, 37), (2, 3)))
def test_tile_list_kernel_matches_plain(cuda, shape):
    """The candidate's list kernel lists the same tiles as its plain twin
    (in no fixed order) and counts them, on random, empty and full planes;
    one launch each."""
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    for density in (0.003, 0.3, 0.0, 1.0):
        cells = torch.rand(shape, generator=g, device=cuda) < density
        for tile in ((8, 16), (8, 8), (4, 8), (4, 4)):
            before = kernels.tile_list.launches
            lst, cnt = kernels.tile_list(cells, *tile)
            ref, rcnt = kernels.tile_list_plain(cells, *tile)
            torch.cuda.synchronize()
            n = int(rcnt)
            assert int(cnt) == n and kernels.tile_list.launches == before + 1
            assert torch.equal(lst[:n].sort().values, ref[:n])


# ---------------------------------------------------------------------------
# the post's and the modal positivity's tile kernels (csrc/fused_post.cu,
# csrc/fused_modal_pos.cu, kernels.post_tile): tiles cut by the grid's
# edge, grids smaller than one tile, the wrap on either axis, solid cells
# on tile and domain edges, the block form's halo lines; each bitwise equal
# to its plain version, with and without diag
# ---------------------------------------------------------------------------

#: (nx, ny) of the post's and the modal positivity's edge cases; "past"
#: is the grid one cell past the degree's tile on both axes
POST_GRIDS = ((1, 1), (3, 2), (2, 37), (40, 1), "past")
#: (per_x, per_y, indicator, char_lim, pos_lim, masked)
POST_FORMS = ((False, False, "density", True, True, False),
              (True, False, "energy", False, True, False),
              (False, True, "limiter", True, True, False),
              (True, True, "density", False, False, False),
              (True, True, "limiter", True, True, False),
              (False, False, "density", True, True, True),
              (True, True, "energy", True, True, True))


def post_grid(grid, p, modal, dt):
    if grid != "past":
        return grid
    ty, tx = kernels.post_tile(p, modal, dt)
    return tx + 1, ty + 1


def noisy_state(family, p, nx, ny, dt, cuda, seed, scale=0.3):
    """The DMR IC on the 4 x 1 box with `scale` relative noise on every DoF
    (numpy seed): the limiter marks cells, positivity moves some."""
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    u = ic.set_initial_condition(make_basis(family, p), mesh, dmr_ic,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    u = u * torch.from_numpy(1.0 + scale * rng.uniform(-1.0, 1.0, u.shape))
    return mesh, u.to(dtype=dt, device=cuda).contiguous()


def post_edge_mask(nx, ny):
    """Solid cells on the domain's four edges and on the tiles' edges
    (columns 7, 8, 15, 16 and rows 3, 4, 7, 8, 15, 16), fluid elsewhere."""
    m = np.ones((ny, nx), bool)
    m[::3, 0] = m[1::4, -1] = False
    m[0, 1::5] = m[-1, ::4] = False
    for x in (7, 8, 15, 16):
        if x < nx:
            m[1::2, x] = False
    for y in (3, 4, 7, 8, 15, 16):
        if y < ny:
            m[y, 2::3] = False
    return m


def all_same_bits(pairs) -> bool:
    torch.cuda.synchronize()
    return all(same_bits(k, q) for k, q in pairs)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("form", POST_FORMS)
@pytest.mark.parametrize("grid", POST_GRIDS)
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_edges_post_is_bitwise_plain(cuda, p, grid, form, dtype):
    """The post at Q1-Q6 on grids cut against its tile and smaller than
    one: periodic in x, y and both, the three indicators, char_lim on and
    off, pos_lim off, masked with solid cells on tile and domain edges;
    with and without diag; one launch each."""
    dt = getattr(torch, dtype)
    nx, ny = post_grid(grid, p, False, dt)
    per_x, per_y, ind, char, pos, masked = form
    mesh, u = noisy_state("Qk", p, nx, ny, dt, cuda, 10 * p + nx)
    post = kernels.post_operators(
        make_basis("Qk", p), mesh, indicator=ind, beta=2.0, char_lim=char,
        pos_lim=pos, per_x=per_x, per_y=per_y,
        mask=post_edge_mask(nx, ny) if masked else None, dtype=dt,
        device=cuda)
    before = kernels.fused_post.launches
    assert all_same_bits([
        (kernels.fused_post(u, post), kernels.fused_post_plain(u, post)),
        *zip(kernels.fused_post(u, post, with_diag=True),
             kernels.fused_post_plain(u, post, with_diag=True))])
    assert kernels.fused_post.launches == before + 2


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_post_nan_cell_reaches_lam_max(cuda, p, dtype):
    """A NaN cell gives NaN in lam_max and trips the fatal flag, as in the
    plain version; the other cells stay bitwise."""
    dt = getattr(torch, dtype)
    mesh, u = noisy_state("Qk", p, 37, 11, dt, cuda, 90 + p)
    u[:, :, 5, 17] = float("nan")
    post = kernels.post_operators(make_basis("Qk", p), mesh,
                                  indicator="density", beta=2.0,
                                  char_lim=True, dtype=dt, device=cuda)
    k = kernels.fused_post(u, post, with_diag=True)
    assert all_same_bits(zip(k, kernels.fused_post_plain(u, post,
                                                         with_diag=True)))
    assert bool(k[1].isnan()) and bool(~(k[2] >= EPS))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("per", ((False, False), (True, False),
                                 (False, True), (True, True)))
@pytest.mark.parametrize("grid", ((34, 18), (6, 4), (2, 2)))
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_edges_block_post_is_bitwise(cuda, p, grid, per, dtype):
    """The block form on four ragged blocks of a (2, 2) virtual mesh,
    periodic on neither, one or both axes (each halo line present and
    absent): bitwise equal to its plain block form, and the sharded post
    bitwise equal to the single-device post."""
    from dflo_tpu_torch.parallel import (exchange_halos, gather_state,
                                         shard_state)
    dt = getattr(torch, dtype)
    mesh, u = noisy_state("Qk", p, *grid, dt, cuda, 70 + p)
    post = kernels.post_operators(make_basis("Qk", p), mesh,
                                  indicator="density", beta=2.0,
                                  char_lim=True, per_x=per[0], per_y=per[1],
                                  dtype=dt, device=cuda)
    dm = _virtual_mesh(cuda)
    blocks = shard_state(u, dm)
    halos = exchange_halos(blocks, dm, *per)
    assert all_same_bits([
        pair for b, h in zip(blocks, halos)
        for pair in zip(kernels.fused_post(b, post, True, halos=h),
                        kernels.fused_post_plain(b, post, True, halos=h))])
    ks, lam, mq = kernels.fused_post_sharded(blocks, [post] * 4, dm, True)
    assert all_same_bits(zip((gather_state(ks, dm), lam, mq),
                             kernels.fused_post(u, post, with_diag=True)))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("grid", POST_GRIDS)
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_edges_modal_pos_is_bitwise_plain(cuda, p, grid, dtype):
    """The modal positivity at P1-P6 in its four forms on grids cut
    against its tile and smaller than one, the degree map holding every
    degree 0..p."""
    dt = getattr(torch, dtype)
    nx, ny = post_grid(grid, p, True, dt)
    mesh, u = noisy_state("Pk", p, nx, ny, dt, cuda, 100 + 10 * p + nx)
    mops = kernels.modal_operators(make_basis("Pk", p), mesh, dtype=dt,
                                   device=cuda)
    rng = np.random.default_rng(p + nx)
    deg = rng.integers(0, p + 1, (ny, nx), dtype=np.int32)
    deg.flat[:min(p + 1, deg.size)] = np.arange(p + 1)[:deg.size]
    deg = torch.from_numpy(deg).to(cuda)
    before = kernels.fused_modal_pos.launches
    assert all_same_bits([
        pair for d in (None, deg)
        for pair in [(kernels.fused_modal_pos(u, mops, d),
                      kernels.fused_modal_pos_plain(u, mops, d)),
                     *zip(kernels.fused_modal_pos(u, mops, d,
                                                  with_diag=True),
                          kernels.fused_modal_pos_plain(u, mops, d,
                                                        with_diag=True))]])
    assert kernels.fused_modal_pos.launches == before + 4


# ---------------------------------------------------------------------------
# the Pk post's and the MOOD check's tile kernels (csrc/fused_pk_post.cu,
# csrc/fused_mood_check.cu, kernels.pk_post_tile and check_tile): grids cut
# against their tiles and smaller than one, periodic on neither, one or both
# axes, marked cells on tile and domain edges, spreads that cross tile
# borders and wrap; each bitwise equal to its plain version
# ---------------------------------------------------------------------------

PER_AXES = ((False, False), (True, False), (False, True), (True, True))
#: (nx, ny) of the Pk post's cases; "past" is the grid one cell past the
#: degree's tile on both axes
PK_POST_GRIDS = ((1, 1), (3, 2), (2, 37), (40, 1), (37, 11), "past")
#: (nx, ny) of the check's cases: rows a 16-byte vector of every plane
#: (256), of the float planes alone (260) and of none (129, 37), and
#: "past", one cell past its tile on both axes
CHECK_GRIDS = ((1, 1), (3, 2), (2, 37), (40, 1), (37, 11), (256, 20),
               (260, 35), "past")


def edge_marks(nx, ny, seed, density=0.5):
    """A random bool plane (numpy seed) set on the domain's four edges and
    on the tiles' edges (columns 7, 8, 15, 16, 127, 128 and rows 3, 4, 7, 8,
    15, 16)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(ny, nx)) < density
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    m[:, [x for x in (7, 8, 15, 16, 127, 128) if x < nx]] = True
    m[[y for y in (3, 4, 7, 8, 15, 16) if y < ny], :] = True
    return m


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("per", PER_AXES)
@pytest.mark.parametrize("grid", PK_POST_GRIDS)
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_edges_pk_post_is_bitwise_plain(cuda, p, grid, per, dtype):
    """The Pk post at P1-P6 on grids cut against its tile and smaller than
    one, periodic on neither, one or both axes, characteristic limiting and
    a TVB M on some, the marked cells on tile and domain edges and half the
    others; with and without diag, one launch each."""
    dt = getattr(torch, dtype)
    if grid == "past":
        ty, tx = kernels.pk_post_tile(p, dt)
        grid = (tx + 1, ty + 1)
    nx, ny = grid
    mesh, u = noisy_state("Pk", p, nx, ny, dt, cuda, 200 + 10 * p + nx)
    post = kernels.pk_post_operators(
        make_basis("Pk", p), mesh, M=10.0 if per == (False, True) else 0.0,
        beta=2.0, char_lim=per != (True, False), per_x=per[0], per_y=per[1],
        dtype=dt, device=cuda)
    shock = torch.from_numpy(np.where(edge_marks(nx, ny, p + nx), 2.0, 0.0)
                             ).to(dtype=dt, device=cuda)
    before = kernels.fused_pk_post.launches
    assert all_same_bits([
        (kernels.fused_pk_post(u, shock, post),
         kernels.fused_pk_post_plain(u, shock, post)),
        *zip(kernels.fused_pk_post(u, shock, post, with_diag=True),
             kernels.fused_pk_post_plain(u, shock, post, with_diag=True))])
    assert kernels.fused_pk_post.launches == before + 2


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("p", (1, 2, 3, 4, 5, 6))
def test_tile_pk_post_nan_cell_reaches_lam_max(cuda, p, dtype):
    """A NaN cell gives NaN in lam_max, as in the plain version; the other
    outputs stay bitwise (NaN where the plain version has NaN)."""
    dt = getattr(torch, dtype)
    mesh, u = noisy_state("Pk", p, 37, 11, dt, cuda, 290 + p)
    u[:, :, 5, 17] = float("nan")
    post = kernels.pk_post_operators(make_basis("Pk", p), mesh, beta=2.0,
                                     char_lim=True, dtype=dt, device=cuda)
    shock = torch.full((11, 37), 2.0, dtype=dt, device=cuda)
    k = kernels.fused_pk_post(u, shock, post, with_diag=True)
    assert all_same_bits(zip(k, kernels.fused_pk_post_plain(
        u, shock, post, with_diag=True)))
    assert bool(k[1].isnan()) and bool(~(k[2] >= EPS))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("per", PER_AXES)
@pytest.mark.parametrize("grid", CHECK_GRIDS)
@pytest.mark.parametrize("p", (2, 3, 4, 5, 6))
def test_tile_edges_mood_check_is_bitwise_plain(cuda, p, grid, per, dtype):
    """The check at p 2-6 on grids cut against its wide tile and smaller
    than one, periodic on neither, one or both axes, with degree-1 marked
    cells on the tile and domain edges, so that spreads cross tile borders
    and wrap; a candidate near the predictor, so the DMP test goes both
    ways.  The three outputs bitwise equal to the plain version's, and on
    grids with cells off the domain's edges some cells change."""
    from dflo_tpu_torch.stab import mood
    dt = getattr(torch, dtype)
    if grid == "past":
        ty, tx = kernels.check_tile(dt)
        grid = (tx + 1, ty + 1)
    nx, ny = grid
    mesh, u = noisy_state("Pk", p, nx, ny, dt, cuda, 400 + 10 * p + nx)
    ops = kernels.mood_check_operators(make_basis("Pk", p), mesh,
                                       per_x=per[0], per_y=per[1],
                                       device=cuda)
    rho0 = ops.avg0 * u[euler.RHO, 0]
    bmin = mood.neighborhood_min(rho0, ops.valid)
    bmax = mood.neighborhood_max(rho0, ops.valid)
    # the candidate: 1e-4 relative noise on the means (DMP fails at most
    # local extrema), the higher modes 1 % of the mean in random signs (the
    # u2 test fails in most cells: the IC's higher modes are 0)
    rng = np.random.default_rng(p + nx)
    cand = u * torch.from_numpy(1.0 + 1e-4 * rng.uniform(-1.0, 1.0, u.shape)
                                ).to(u)
    cand[:, 1:] += 0.01 * cand[:, :1] * torch.from_numpy(
        rng.uniform(-1.0, 1.0, cand[:, 1:].shape)).to(u)
    cand = cand.contiguous()
    edges = edge_marks(nx, ny, 7 * p + nx, density=0.3)
    deg = np.where(edges, 1, rng.integers(1, p + 1, (ny, nx))).astype(np.int32)
    lim = edges & (rng.uniform(size=(ny, nx)) < 0.7)
    deg, lim = torch.from_numpy(deg).to(cuda), torch.from_numpy(lim).to(cuda)
    before = kernels.fused_mood_check.launches
    k = kernels.fused_mood_check(cand, bmin, bmax, deg, lim, ops)
    q = kernels.fused_mood_check_plain(cand, bmin, bmax, deg, lim, ops)
    torch.cuda.synchronize()
    assert kernels.fused_mood_check.launches == before + 1
    for a, b in zip(k, q):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert k[0].dtype == torch.int32 and k[1].dtype == k[2].dtype == torch.bool
    if min(nx, ny) > 2:      # cells off the domain's edges (deg 1 there)
        assert 0 < int(k[2].sum())


# ---------------------------------------------------------------------------
# the diag as one launch (csrc/fused_diag.cu) and the volume residual's
# tile kernel (csrc/volume_residual.cu): every form bitwise
# ---------------------------------------------------------------------------

#: (nx, ny): rows a 16-byte vector of cells covers (nx % 4 == 0) and rows
#: it does not, odd row counts, grids smaller than one run, tile or block
DV_GRIDS = ((96, 20), (33, 17), (130, 9), (64, 7), (5, 3), (1, 1))
DIAG_BASES = (*(("Pk", p, None) for p in range(1, 7)),
              *(("Qk", p, None) for p in range(1, 7)),
              *(("Qk_gll", p, None) for p in range(1, 7)),
              ("Pk", 2, 4), ("Pk", 6, 8), ("Qk", 2, 4), ("Qk_gll", 5, 7))


def dv_mask(nx, ny, seed):
    """Random fluid flags, about a quarter of the cells solid."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(ny, nx)) > 0.25


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("case", DIAG_BASES)
def test_diag_forms_are_bitwise_plain(cuda, case, dtype):
    """The diag over every basis kind (the Pk mode-0 mean, the nodal full
    row, over-integrated bases of both) on every grid of DV_GRIDS, masked
    and not, on a workspace of two blocks (the grid-stride loop's later
    rounds) and on a state whose storage starts 4 bytes past a 16-byte
    boundary (the element loads on a grid the vector loads would take):
    (lam_max, minq) equal to the plain version's, one launch a call."""
    family, p, nq = case
    dt = getattr(torch, dtype)
    basis = make_basis(family, p, nq)
    for nx, ny in DV_GRIDS:
        mesh, u = noisy_state(family, p, nx, ny, dt, cuda, 500 + p + nx)
        for mask in (None, dv_mask(nx, ny, p + nx)):
            ops = kernels.diag_operators(basis, mesh, mask=mask, dtype=dt,
                                         device=cuda)
            assert ops.mode0 == (family == "Pk")
            before = kernels.fused_diag.launches
            got = kernels.fused_diag(u, ops)
            assert kernels.fused_diag.launches == before + 1
            assert all(same_bits(a, b) for a, b in
                       zip(got, kernels.fused_diag_plain(u, ops)))
            # twice in a row: the ticket is back at 0 after each launch
            assert all(same_bits(a, b) for a, b in
                       zip(kernels.fused_diag(u, ops), got))
            assert int(ops.ticket) == 0
            # a workspace of 2 blocks: the grid-stride loop's later rounds
            narrow = dataclasses.replace(ops, part=ops.part[:4].clone(),
                                         ticket=torch.zeros_like(ops.ticket))
            assert all(same_bits(a, b) for a, b in
                       zip(kernels.fused_diag(u, narrow), got))
            assert int(narrow.ticket) == 0
        buf = torch.empty(u.numel() + 1, dtype=dt, device=cuda)
        off = buf[1:].view(u.shape)
        off.copy_(u)
        assert off.data_ptr() % 16 != 0
        assert all(same_bits(a, b) for a, b in
                   zip(kernels.fused_diag(off, ops),
                       kernels.fused_diag_plain(u, ops)))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("family", ("Pk", "Qk"))
def test_diag_nan_cell_makes_minq_nan(cuda, family, dtype):
    """One NaN fluid cell makes lam and minq NaN (the fatal flag trips);
    the same NaN in a solid cell enters neither reduction."""
    dt = getattr(torch, dtype)
    mesh, u = noisy_state(family, 3, 33, 17, dt, cuda, 610)
    mask = np.ones((17, 33), bool)
    mask[8, 13] = False
    ops = kernels.diag_operators(make_basis(family, 3), mesh, mask=mask,
                                 dtype=dt, device=cuda)
    clean = kernels.fused_diag(u, ops)
    u[:, :, 8, 13] = float("nan")
    assert all(same_bits(a, b) for a, b in
               zip(kernels.fused_diag(u, ops), clean))
    u[:, :, 16, 32] = float("nan")
    lam, minq = kernels.fused_diag(u, ops)
    assert bool(lam.isnan()) and bool(minq.isnan()) and not bool(minq >= EPS)
    assert all(same_bits(a, b) for a, b in
               zip((lam, minq), kernels.fused_diag_plain(u, ops)))


@pytest.mark.parametrize("family", ("Pk", "Qk"))
def test_diag_call_is_one_kernel(cuda, family):
    """A diag call launches one kernel on the card and nothing after it
    (no reduction over partials): a torch.profiler trace of 10 calls holds
    10 device events, each the diag kernel (traced again, up to three
    times, where a trace dropped an event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mesh, u = noisy_state(family, 2, 256, 128, torch.float32, cuda, 620)
    ops = kernels.diag_operators(make_basis(family, 2), mesh,
                                 dtype=torch.float32, device=cuda)
    kernels.fused_diag(u, ops)
    torch.cuda.synchronize()
    for _ in range(3):    # a trace that drops an event is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernels.fused_diag(u, ops)
            torch.cuda.synchronize()
        evs = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if len(evs) == 10:
            break
    assert len(evs) == 10, evs
    assert all("fused_diag_kernel" in n for n in evs), evs


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("case", (("Pk", 2), ("Qk", 4), ("Qk_gll", 2)))
def test_sharded_diag_equals_single_device_diag(cuda, case, dtype):
    """The sharded diag (row 7: the diag per block of a (2, 2) virtual
    mesh, one workspace per block, then max / min across the blocks)
    equals the single-device diag and its own plain version bitwise."""
    from dflo_tpu_torch.parallel import shard_state
    family, p = case
    dt = getattr(torch, dtype)
    mesh, u = noisy_state(family, p, 96, 20, dt, cuda, 630 + p)
    basis = make_basis(family, p)
    ops = kernels.diag_operators(basis, mesh, dtype=dt, device=cuda)
    dm = _virtual_mesh(cuda)
    blocks = shard_state(u, dm)
    bops = [kernels.diag_operators(basis, mesh, dtype=dt, device=cuda)
            for _ in blocks]
    before = kernels.fused_diag_sharded.launches
    got = kernels.fused_diag_sharded(blocks, bops, dm)
    assert kernels.fused_diag_sharded.launches == before + 4
    assert all(same_bits(a, b) for a, b in
               zip(got, kernels.fused_diag(u, ops)))
    assert all(same_bits(a, b) for a, b in
               zip(got, kernels.fused_diag_sharded_plain(blocks, bops, dm)))


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("family", ("Qk", "Qk_gll"))
@pytest.mark.parametrize("p", range(1, 7))
def test_volume_forms_are_bitwise_plain(cuda, p, family, dtype):
    """volume_residual at Q1-Q6 and GLL1-GLL6 (the per-cell kernel up to
    VOLUME_CELL_MAX_P, the tile kernel above) on every grid of DV_GRIDS:
    equal to the plain version bitwise, one launch a call."""
    dt = getattr(torch, dtype)
    basis = make_basis(family, p)
    for nx, ny in DV_GRIDS:
        mesh, u = noisy_state(family, p, nx, ny, dt, cuda, 700 + p + nx,
                              scale=0.05)
        rhs = make_rhs(basis, mesh, BCS, dtype=dt, device=cuda,
                       volume_kernel="pallas")
        before = kernels.volume_residual.launches
        k = kernels.volume_residual(rhs.lift_stack, u)
        q = kernels.volume_residual_plain(rhs.lift_stack, u)
        torch.cuda.synchronize()
        assert kernels.volume_residual.launches == before + 1
        assert same_bits(k, q), (nx, ny)


# ---------------------------------------------------------------------------
# mesh files, segmented sides and curvilinear blocks
# ---------------------------------------------------------------------------

def segmented_dmr_bcs(nx: int, ny: int):
    """The DMR sides with the bottom split at x = 1/6: post-shock farfield
    before, slip after (the reference's grid.geo Physical Lines 0/1)."""
    xc = (np.arange(nx) + 0.5) * 4.0 / nx
    seg = (xc > 1.0 / 6.0).astype(np.int32)
    bottom = SegmentedSide(seg, (BoundarySide(euler.BC_FARFIELD, dmr_inflow),
                                 BoundarySide(euler.BC_SLIP)))
    return dict(BCS, S=bottom)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_segmented_stage_and_candidate_are_bitwise_plain(cuda, dtype):
    """With the split DMR bottom: the Q2 SSP-stage form of the residual
    (row 2) and the P2 MOOD candidate on its tp'd strips (row 3), each
    equal to its plain version bitwise; the segments change the strips."""
    dt = getattr(torch, dtype)
    bcs = segmented_dmr_bcs(NX, NY)
    u, post, _, _ = setup(2, dt, cuda)
    u = kernels.fused_post_plain(u, post)
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    rhs = make_rhs(make_basis("Qk", 2), mesh, bcs, flux="hllc", dtype=dt,
                   device=cuda, volume_kernel="fused")
    t = torch.full((), 0.05, dtype=dt, device=cuda)
    strips = rhs.strips(u, t)
    whole = make_rhs(make_basis("Qk", 2), mesh, BCS, flux="hllc", dtype=dt,
                     device=cuda, volume_kernel="fused").strips(u, t)
    assert not torch.equal(strips[2], whole[2])
    assert torch.equal(strips[3], whole[3])
    sc = torch.tensor([0.75, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    before = kernels.fused_residual.launches
    k = kernels.fused_residual(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    q = kernels.fused_residual_plain(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    torch.cuda.synchronize()
    assert kernels.fused_residual.launches == before + 1
    assert same_bits(k, q)

    _, pmesh, up, _, pl = setup_pk(2, dt, cuda, seed=31, ny=NY, nx=NX)
    prhs = make_rhs(make_basis("Pk", 2), pmesh, bcs, flux="hllc", dtype=dt,
                    device=cuda, volume_kernel="fused")
    tp = prhs.strips(up, t, pl["deg"])
    h = torch.full((), 1e-4, dtype=dt, device=cuda)
    prev = up.flip(-1).contiguous()
    for cells in (pl["cells"], torch.ones_like(pl["cells"])):
        before = kernels.fused_mood_candidate.launches
        k = prhs.sparse_candidate(up, prev.clone(), pl["deg"], t, h, cells)
        q = kernels.fused_mood_candidate_plain(
            up, prev.clone(), pl["deg"], cells, *tp, prhs.ops,
            prhs.modal_ops, h)
        torch.cuda.synchronize()
        assert kernels.fused_mood_candidate.launches == before + 1
        assert same_bits(k, q)


@pytest.mark.parametrize("case", ("wavy", "annulus"))
def test_curvilinear_rhs_on_the_card_matches_cpu(cuda, case):
    """The curvilinear residual (plain torch on every device, as the
    reference's is XLA) on the card in f64 against the CPU within 1e-12,
    with a segmented bottom on the wavy block."""
    from dflo_tpu_torch.mesh.curvilinear import annulus_mesh, wavy_mesh
    from dflo_tpu_torch.solver.spatial_curvi import make_rhs_curvilinear
    basis = make_basis("Qk", 2)
    per = BoundarySide(euler.BC_PERIODIC)
    if case == "wavy":
        mesh = wavy_mesh(40, 16, 0.0, 4.0, 0.0, 1.0, amp=0.05)
        bcs = segmented_dmr_bcs(40, 16)
    else:
        mesh = annulus_mesh(1.0, 3.0, 16, 96)
        bcs = dict(W=per, E=per, S=BoundarySide(euler.BC_SLIP),
                   N=BoundarySide(euler.BC_FARFIELD, dmr_inflow))
    rng = np.random.default_rng(41)
    u = ic.set_initial_condition(basis, mesh, dmr_inflow, dtype=torch.float64,
                                 device="cpu")
    u = u * torch.from_numpy(1.0 + 0.05 * rng.uniform(-1, 1, u.shape))
    out = []
    for dev in ("cpu", cuda):
        rhs = make_rhs_curvilinear(basis, mesh, bcs, flux="hllc",
                                   dtype=torch.float64, device=dev)
        out.append(rhs(u.to(dev), 0.05).cpu())
    assert rel(out[1], out[0]) <= 1e-12


def test_cli_runs_mesh_files_on_the_card(cuda, tmp_path):
    """cli.run on the card (no --platform): the .geo DMR at 48 x 12 through
    the residual, post and diag kernels, and a 32 x 8 NACA 0012 .struct
    with examples/naca0012.prm's settings, one PTC step per level."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.entry import dmr_geo_prm, dmr_geo_text
    from dflo_tpu_torch.mesh.curvilinear import naca0012_omesh, write_struct
    (tmp_path / "dmr.geo").write_text(dmr_geo_text(2, 46, 12))
    (tmp_path / "dmr.prm").write_text(dmr_geo_prm("dmr.geo"))
    kernels.reset_launch_counts()
    res = cli.run([str(tmp_path / "dmr.prm"), "--max-steps", "3",
                   "--output-dir", str(tmp_path / "out_dmr")])
    counts = kernels.launch_counts()
    assert res.it == 3 and res.u.is_cuda and bool(torch.isfinite(res.u).all())
    assert isinstance(res.solver.bcs["S"], SegmentedSide)
    assert all(counts[k] > 0 for k in ("fused_residual", "fused_post",
                                       "fused_diag")), counts

    write_struct(str(tmp_path / "naca.struct"), naca0012_omesh(32, 8))
    text = open("examples/naca0012.prm").read()
    text = "\n".join("set mesh file = naca.struct"
                     if ln.startswith("set mesh file") else ln
                     for ln in text.splitlines())
    (tmp_path / "naca.prm").write_text(text)
    res = cli.run([str(tmp_path / "naca.prm"), "--max-steps", "1",
                   "--output-dir", str(tmp_path / "out_naca")])
    assert res.solver.curvilinear and res.u.is_cuda
    assert [len(h) for h in res.steady_levels] == [1, 1]
    assert bool(torch.isfinite(res.u).all())


# ---------------------------------------------------------------------------
# the rest of the physics envelope: pressure sides, minmax, u2, MOOD off
# the fused route
# ---------------------------------------------------------------------------

def outlet_pressure(x, y, t):
    """A pressure side's values: the free stream's pressure 1.0 in the
    energy slot (the forward step's)."""
    z = torch.zeros_like(x)
    return torch.stack([z, z, z, z + 1.0])


@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_pressure_strip_stage_is_bitwise_plain(cuda, dtype):
    """The masked Q1 forward step at 96 x 32 (lxf, the step's solid cells)
    with its outlet a pressure side: the SSP-stage form of the residual
    (row 2) on the pressure strips equals its plain version bitwise, and the
    pressure side changes the E strip."""
    dt = getattr(torch, dtype)
    mesh = CartesianMesh(96, 32, 0.0, 3.0, 0.0, 1.0)
    xc, yc = mesh.cell_centers()
    mask = ~((xc > 0.6) & (yc < 0.2))

    def inflow(x, y, t):
        return torch.stack([torch.full_like(x, v)
                            for v in (4.2, 0.0, 1.4, 8.8)])

    slip = BoundarySide(euler.BC_SLIP)
    bcs = dict(W=BoundarySide(euler.BC_INFLOW, inflow),
               E=BoundarySide(euler.BC_PRESSURE, outlet_pressure), S=slip,
               N=slip)
    basis = make_basis("Qk", 1)
    gen = torch.Generator().manual_seed(17)
    u = ic.set_initial_condition(basis, mesh, inflow, dtype=torch.float64,
                                 device="cpu")
    u = u * (1.0 + 0.05 * (2.0 * torch.rand(u.shape, generator=gen,
                                            dtype=torch.float64) - 1.0))
    u = u.to(dtype=dt, device=cuda)
    rhs = make_rhs(basis, mesh, bcs, flux="lxf", dtype=dt, device=cuda,
                   volume_kernel="fused", mask=mask)
    t = torch.full((), 0.05, dtype=dt, device=cuda)
    strips = rhs.strips(u, t)
    out = make_rhs(basis, mesh, dict(bcs, E=BoundarySide(euler.BC_OUTFLOW)),
                   flux="lxf", dtype=dt, device=cuda, volume_kernel="fused",
                   mask=mask).strips(u, t)
    assert not torch.equal(strips[1], out[1])
    sc = torch.tensor([0.5, 1e-4], dtype=dt, device=cuda)
    u_old = u.flip(-1).contiguous()
    before = kernels.fused_residual.launches
    k = kernels.fused_residual(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    q = kernels.fused_residual_plain(u, *strips, rhs.ops, u_old=u_old, sc=sc)
    torch.cuda.synchronize()
    assert kernels.fused_residual.launches == before + 1
    assert same_bits(k, q)


def test_mood_xla_route_launches_no_mood_kernel(cuda):
    """The P2 DMR MOOD with volume_kernel="xla" at 96 x 24, f32, two steps:
    the candidate, the modal positivity, the Pk post and the check (rows 3,
    8, 9 and 10) and the residual kernel are not launched, the diag (row 6)
    is, as the reference routes a cascade without its fused residual."""
    from dflo_tpu_torch import entry
    s, u0 = entry._build(96, 24, dtype=torch.float32, device=cuda,
                         method="mood", volume_kernel="xla")
    u = s.post_stage(u0)
    kernels.reset_launch_counts()
    u, t, n, bad, stats = s._multi_step(2)(u, 0.0, 1.0)
    counts = kernels.launch_counts()
    assert int(n) == 2 and not bool(bad) and bool(torch.isfinite(u).all())
    for k in ("fused_mood_candidate", "fused_modal_pos", "fused_pk_post",
              "fused_mood_check", "fused_residual"):
        assert counts[k] == 0, counts
    assert counts["fused_diag"] > 0 and int(stats.n_reduce) > 0


@pytest.mark.parametrize("case", ("minmax_q2", "u2_p2"))
def test_envelope_steps_on_the_card_match_cpu(cuda, case):
    """Three f32 steps of the 96 x 24 DMR with minmax on Q2 (characteristic,
    density indicator, positivity) or TVB with the u2 indicator on P2, on
    the card (the residual kernel, the plain post) against the same steps
    of the port on the CPU (the kernels' plain versions), 1e-5 relative."""
    from dflo_tpu_torch import entry
    from dflo_tpu_torch.driver import LimiterConfig
    if case == "minmax_q2":
        kw = dict(limiter=LimiterConfig(type="minmax",
                                        shock_indicator="density",
                                        char_lim=True, pos_lim=True))
    else:
        kw = dict(family="Pk", limiter=LimiterConfig(
            type="TVB", shock_indicator="u2", beta=2.0, char_lim=True,
            pos_lim=True))
    out = []
    for dev in (cuda, "cpu"):
        s, u0 = entry._build(96, 24, dtype=torch.float32, device=dev, **kw)
        u, t = s.post_stage(u0), 0.0
        kernels.reset_launch_counts()
        for _ in range(3):
            u, dt, bad, _ = s._step(u, t, 1.0)
            t += float(dt)
            assert not bool(bad)
        if dev == cuda:
            counts = kernels.launch_counts()
            assert counts["fused_residual"] == 3 * len(s.ark), counts
            assert counts["fused_post"] == 0, counts
        out.append(u.cpu())
    assert rel(out[0], out[1]) <= 1e-5
