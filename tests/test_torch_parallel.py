"""The port's domain decomposition (dflo_tpu_torch.parallel, the sharded
residual, post, diag and Solver, the CLI's --devices) on CPU blocks, in
float64.

One process holds the state as a grid of blocks; on the CPU every block
lies on the CPU and every kernel wrapper takes its plain version, so these
tests hold the block forms of the plain versions to the single-block port
and to the JAX package's single-device XLA path (the reference the JAX
sharded kernels are held to in tests/test_parallel.py; the JAX sharded
Pallas kernels are not driven here).  Tolerances: the block-form post is
bitwise equal to the single-block post (the same numbers through the same
operations); the sharded residual differs from the single-block one by the
round-off of the seam delta strips (F_wrap + (F_seam - F_wrap)), held at
1e-12 relative; five limited SSP-RK3 steps keep the state within 1e-10 and
each dt within 1e-14 relative.
"""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.parallel import sharding as jsharding
from dflo_tpu_torch import cli, entry, interop
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel import (compatible_shape, device_mesh,
                                     exchange_halos, gather_state,
                                     mesh_grid_shape, shard_state)
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs

F64 = torch.float64
CPU = torch.device("cpu")
SHAPES = ((2, 2), (1, 4), (4, 1))
NX, NY = 32, 8           # the DMR grid of the solver tests
STEPS = 5


def mesh_of(shape):
    return device_mesh(shape, [CPU] * (shape[0] * shape[1]))


def rel(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def nodal(basis, mesh, fn, seed=None):
    """The Qk nodal interpolant of the numpy IC fn(x, y) -> [4, ...], with
    a seeded 2 % perturbation of every DoF when seed is given."""
    xn, yn = mesh.point_coords(basis.nodes)
    u = np.asarray(fn(xn, yn))
    if seed is not None:
        rng = np.random.default_rng(seed)
        u = u * (1.0 + 0.02 * rng.uniform(-1.0, 1.0, u.shape))
    return interop.state_from_numpy(u, F64, CPU)


def conserved(rho, vx, vy, p):
    return np.stack([rho * vx, rho * vy, rho,
                     p / (euler.GAMMA - 1.0) + 0.5 * rho * (vx**2 + vy**2)])


def smooth_sod(x, y):
    """The tanh-smoothed Sod front of tests/test_parallel.py:465-475."""
    s = 0.5 * (1.0 - np.tanh((x - 0.5) / 0.004))
    return conserved(0.125 + 0.875 * s, 0.4 * np.sin(6.0 * x) * (1.0 - s),
                     np.zeros_like(x), 0.1 + 0.9 * s)


def bumpy_vortex(x, y):
    """The isentropic vortex with a tanh bump in density and energy
    (tests/test_parallel.py:509-541)."""
    a1 = 0.5 * 5.0 / np.pi
    a2 = (euler.GAMMA - 1.0) * a1 * a1 / 2.0
    r2 = x * x + y * y
    rho = (1.0 - a2 * np.exp(1.0 - r2)) ** (1.0 / (euler.GAMMA - 1.0))
    u = conserved(rho, -a1 * y * np.exp(0.5 * (1.0 - r2)),
                  a1 * x * np.exp(0.5 * (1.0 - r2)), rho ** euler.GAMMA)
    s = 0.5 * (1.0 - np.tanh((x + y) / 0.2))
    u[euler.RHO] *= 1.0 + 0.5 * s
    u[euler.ENE] *= 1.0 + 0.8 * s
    return u


def wavy_inflow(x, y, t):
    """Inflow data that varies along the side, so a block's boundary flux
    must read the face coordinates at its own offset."""
    rho = 1.0 + 0.2 * torch.sin(3.0 * x + 2.0 * y)
    vx = 0.5 + 0.1 * torch.cos(2.0 * y)
    vy = 0.1 * torch.sin(x)
    p = 1.0 + 0.1 * x
    return torch.stack([rho * vx, rho * vy, rho,
                        p / (euler.GAMMA - 1.0)
                        + 0.5 * rho * (vx * vx + vy * vy)])


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_device_mesh_and_compatible_shape_match_jax():
    import jax
    cpus = jax.devices("cpu")
    for n in range(1, len(cpus) + 1):
        assert (device_mesh(devices=[CPU] * n).shape
                == jsharding.device_mesh(devices=cpus[:n]).devices.shape)
    for n, ny, nx in ((1, 8, 32), (2, 8, 32), (4, 8, 32), (4, 6, 30),
                      (4, 9, 27), (6, 12, 18), (8, 16, 64), (8, 24, 128),
                      (3, 7, 11), (5, 10, 25), (6, 7, 12)):
        assert compatible_shape(n, ny, nx) == jsharding.compatible_shape(
            n, ny, nx), (n, ny, nx)
    assert mesh_grid_shape(device_mesh((2, 4), [CPU] * 8)) == \
        jsharding.mesh_grid_shape(jsharding.device_mesh((2, 4), cpus[:8]))
    with pytest.raises(ValueError, match="shape"):
        device_mesh((2, 3), [CPU] * 4)


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_gather_round_trip(shape):
    dm = mesh_of(shape)
    u = torch.arange(4 * 9 * 8 * 16, dtype=F64).view(4, 9, 8, 16)
    blocks = shard_state(u, dm)
    ly, lx = 8 // shape[0], 16 // shape[1]
    assert len(blocks) == 4
    for k, b in enumerate(blocks):      # row-major: block (iy, ix)
        iy, ix = divmod(k, shape[1])
        assert b.is_contiguous() and torch.equal(
            b, u[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx])
    assert torch.equal(gather_state(blocks, dm), u)
    blocks[0].zero_()                  # the blocks are copies
    assert u[0, 0, 0, 0] == 0 and u[0, 0, 0, 1] == 1
    with pytest.raises(ValueError, match="divisible"):
        shard_state(u[..., :7, :15], dm)


@pytest.mark.parametrize("per", ((False, False), (True, True), (True, False)))
@pytest.mark.parametrize("shape", SHAPES)
def test_halo_lines_are_the_neighbor_lines(shape, per):
    dm = mesh_of(shape)
    ny, nx = 8, 16
    u = torch.randn(4, 9, ny, nx, dtype=F64,
                    generator=torch.Generator().manual_seed(3))
    halos = exchange_halos(shard_state(u, dm), dm, *per)
    DY, DX = shape
    ly, lx = ny // DY, nx // DX
    for k, (hW, hE, hS, hN) in enumerate(halos):
        iy, ix = divmod(k, DX)
        ys, xs = slice(iy * ly, (iy + 1) * ly), slice(ix * lx, (ix + 1) * lx)
        x0, x1 = ix * lx, (ix + 1) * lx - 1
        y0, y1 = iy * ly, (iy + 1) * ly - 1
        for h, edge, want in (
                (hW, x0 == 0 and not per[0], u[..., ys, (x0 - 1) % nx]),
                (hE, x1 == nx - 1 and not per[0], u[..., ys, (x1 + 1) % nx]),
                (hS, y0 == 0 and not per[1], u[..., (y0 - 1) % ny, xs]),
                (hN, y1 == ny - 1 and not per[1], u[..., (y1 + 1) % ny, xs])):
            if edge:
                assert h is None
            else:
                assert h.is_contiguous() and torch.equal(h, want)


# ---------------------------------------------------------------------------
# the block form of the post and the sharded diag
# ---------------------------------------------------------------------------

def _post_case(name):
    basis = make_basis("Qk", 2)
    if name == "sod":
        # dx = 1/256, as the JAX test's 1024 x 16 on [0, 4] x [0, 0.125]
        mesh = CartesianMesh(64, 16, 0.375, 0.625, 0.0, 0.0625)
        per, ind, fn = (False, False), "density", smooth_sod
    else:
        mesh = CartesianMesh(32, 16, -5.0, 5.0, -5.0, 5.0)
        per, ind, fn = (True, True), "limiter", bumpy_vortex
    ops = kernels.post_operators(basis, mesh, indicator=ind, beta=2.0,
                                 char_lim=True, pos_lim=True, per_x=per[0],
                                 per_y=per[1], dtype=F64, device=CPU)
    diag = kernels.diag_operators(basis, mesh, dtype=F64, device=CPU)
    return nodal(basis, mesh, fn), ops, diag


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ("sod", "vortex"))
def test_block_post_equals_single_post(case, shape):
    u, ops, diag = _post_case(case)
    u1, lam1, mq1 = kernels.fused_post_plain(u, ops, with_diag=True)
    assert float((u1 - u).abs().max()) > 1e-8      # the chain does work
    dm = mesh_of(shape)
    blocks = shard_state(u, dm)
    ops_b = [ops] * 4
    outs, lam, mq = kernels.fused_post_sharded(blocks, ops_b, dm,
                                               with_diag=True)
    assert torch.equal(gather_state(outs, dm), u1)
    assert torch.equal(lam, lam1) and torch.equal(mq, mq1)
    plain = kernels.fused_post_sharded_plain(blocks, ops_b, dm)
    assert torch.equal(gather_state(plain, dm), u1)
    # the block form itself, one block at a time
    halos = exchange_halos(blocks, dm, ops.per_x, ops.per_y)
    for b, h, o in zip(blocks, halos, outs):
        assert torch.equal(kernels.fused_post(b, ops, halos=h), o)
    lam_d, mq_d = kernels.fused_diag_sharded(blocks, [diag] * 4, dm)
    lam_p, mq_p = kernels.fused_diag_sharded_plain(blocks, [diag] * 4, dm)
    lam_1, mq_1 = kernels.fused_diag(u, diag)
    assert torch.equal(lam_d, lam_1) and torch.equal(mq_d, mq_1)
    assert torch.equal(lam_p, lam_1) and torch.equal(mq_p, mq_1)


def test_nan_block_reaches_the_sharded_flags():
    u, ops, diag = _post_case("sod")
    u[:, :, 12, 50] = float("nan")
    dm = mesh_of((2, 2))
    blocks = shard_state(u, dm)
    _, lam, mq = kernels.fused_post_sharded(blocks, [ops] * 4, dm, True)
    lam_d, mq_d = kernels.fused_diag_sharded(blocks, [diag] * 4, dm)
    assert all(bool(torch.isnan(v)) for v in (lam, mq, lam_d, mq_d))


# ---------------------------------------------------------------------------
# the sharded residual
# ---------------------------------------------------------------------------

PER = BoundarySide(euler.BC_PERIODIC)
RHS_BCS = {
    "edges": dict(W=BoundarySide(euler.BC_INFLOW, wavy_inflow),
                  E=BoundarySide(euler.BC_OUTFLOW),
                  S=BoundarySide(euler.BC_SLIP),
                  N=BoundarySide(euler.BC_FARFIELD, wavy_inflow)),
    "periodic": dict(W=PER, E=PER, S=PER, N=PER),
    "periodic_x": dict(W=PER, E=PER, S=BoundarySide(euler.BC_SLIP),
                       N=BoundarySide(euler.BC_FARFIELD, wavy_inflow)),
}


@pytest.fixture(scope="module")
def rhs_states():
    """Two limited, perturbed DMR states at 32 x 8 (u and u_old)."""
    s, _ = entry._build(32, 8, dtype=F64, device=CPU)
    return tuple(s.post_stage(nodal(s.basis, s.mesh, entry_ic, seed=k))
                 for k in (1, 2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("flux", ("hllc", "lxf"))
@pytest.mark.parametrize("sides", tuple(RHS_BCS))
def test_sharded_rhs_and_stage_match_single(rhs_states, sides, flux, shape):
    basis = make_basis("Qk", 2)
    mesh = CartesianMesh(32, 8, 0.0, 4.0, 0.0, 1.0)
    bcs = RHS_BCS[sides]
    u, u_old = rhs_states
    kw = dict(dtype=F64, device=CPU, volume_kernel="fused")
    r1 = make_rhs(basis, mesh, bcs, flux, **kw)
    dm = mesh_of(shape)
    rN = make_rhs(basis, mesh, bcs, flux, device_mesh=dm, **kw)
    t = torch.tensor(0.3, dtype=F64)
    dt = torch.tensor(2e-4, dtype=F64)
    blocks, old = shard_state(u, dm), shard_state(u_old, dm)
    assert rel(r1(u, t), gather_state(rN(blocks, t), dm)) <= 1e-12
    assert rel(make_rhs(basis, mesh, bcs, flux, dtype=F64, device=CPU)(u, t),
               gather_state(rN(blocks, t), dm)) <= 1e-12
    assert rel(r1.stage(u, u_old, t, 0.75, dt),
               gather_state(rN.stage(blocks, old, t, 0.75, dt), dm)) <= 1e-12


def entry_ic(x, y):
    """The DMR's Mach-10 oblique shock (entry.dmr_ic) in numpy."""
    post = x < (1.0 / 6.0 + y / np.sqrt(3.0))
    return conserved(np.where(post, 8.0, 1.4), np.where(post, 7.14471, 0.0),
                     np.where(post, -4.125, 0.0), np.where(post, 116.5, 1.0))


# ---------------------------------------------------------------------------
# the sharded Solver, entry points and CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def start():
    """The post-staged DMR IC at 32 x 8 (numpy) and the port's single-block
    run of STEPS steps from it: [(u, dt, bad)]."""
    s, u0 = entry._build(NX, NY, dtype=F64, device=CPU)
    u = s.post_stage(u0)
    u_np = u.numpy().copy()
    t, out = 0.0, []
    for _ in range(STEPS):
        u, dt, bad, _ = s._step(u, t, 1.0)
        t += float(dt)
        out.append((u, float(dt), bool(bad)))
    return u_np, out


@pytest.fixture(scope="module")
def jax_steps(start):
    """dflo_tpu's Solver (volume_kernel="xla", post_kernel="xla": the
    single-device XLA path) from the same numpy state."""
    import jax.numpy as jnp
    js, _ = graft._build(NX, NY, volume_kernel="xla", post_kernel="xla")
    u, t, out = jnp.asarray(start[0]), 0.0, []
    for _ in range(STEPS):
        u, dt, bad, _ = js._step(u, t, 1.0)
        t += float(dt)
        out.append((np.asarray(u), float(dt), bool(bad)))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_solver_matches_single_and_jax(start, jax_steps, shape):
    u_np, single = start
    s, _ = entry._build(NX, NY, dtype=F64, device=CPU,
                        device_mesh=mesh_of(shape))
    blocks = s.shard(interop.state_from_numpy(u_np, F64, CPU))
    t = 0.0
    for k in range(STEPS):
        blocks, dt, bad, _ = s._step(blocks, t, 1.0)
        t += float(dt)
        u_ref, dt_ref, bad_ref = single[k]
        u_jax, dt_jax, _ = jax_steps[k]
        assert abs(float(dt) - dt_ref) <= 1e-14 * dt_ref, k
        assert abs(float(dt) - dt_jax) <= 1e-14 * dt_jax, k
        assert not bool(bad) and not bad_ref
        u = s.gather(blocks)
        assert rel(u_ref, u) <= 1e-10 and rel(u_jax, u) <= 1e-10, k
    assert len(blocks) == 4 and blocks[0].shape == (4, 9, NY // shape[0],
                                                    NX // shape[1])


def test_sharded_multi_step_run_and_flags(start):
    u_np, single = start
    s, u0 = entry._build(NX, NY, dtype=F64, device=CPU,
                         device_mesh=mesh_of((2, 2)))
    u = s.shard(interop.state_from_numpy(u_np, F64, CPU))
    um, tm, n, bad, _ = s._multi_step(3)(u, 0.0, 1.0)
    assert int(n) == 3 and not bool(bad)
    assert rel(single[2][0], s.gather(um)) <= 1e-10
    assert abs(float(tm) - sum(r[1] for r in single[:3])) <= 1e-16
    t_end = sum(r[1] for r in single[:2])
    ur, tr, it = s.run(s.shard(u0), t_end, chunk=4)
    assert it == 2 and abs(tr - t_end) <= 1e-15
    assert rel(single[1][0], s.gather(ur)) <= 1e-10
    u_nan = s.gather(u).clone()
    u_nan[:, :, 5, 20] = float("nan")
    _, _, bad, _ = s._step(s.shard(u_nan), 0.0, 1.0)
    assert bool(bad)
    _, _, n, bad, _ = s._multi_step(2)(s.shard(u_nan), 0.0, 1.0)
    assert bool(bad) and int(n) == 1


def test_dryrun_multichip_on_cpu_blocks():
    for n in (2, 4):
        entry.dryrun_multichip(n, device="cpu")


def test_cli_devices_matches_one_device(tmp_path):
    """examples/implosion.prm (Qk, LxF, slip box, expression IC) cut to
    32 x 32: 5 steps on 4 CPU blocks against the run on one."""
    src = open("examples/implosion.prm").read()
    prm = tmp_path / "implosion.prm"
    prm.write_text(src.replace("nx = 100", "nx = 32")
                   .replace("ny = 100", "ny = 32"))
    runs = {}
    for n in (0, 4):
        out = tmp_path / f"dev{n}"
        res = cli.run([str(prm), "--platform", "cpu", "--x64", "--devices",
                       str(n), "--max-steps", "5", "--checkpoint-every", "1",
                       "--output-dir", str(out)])
        assert res.it == 5 and isinstance(res.u, torch.Tensor)
        with np.load(os.path.join(out, "checkpoint-001.npz")) as z:
            runs[n] = (res, z["u"], float(z["t"]))
    assert runs[4][0].solver.device_mesh.shape == (2, 2)
    assert runs[4][2] == pytest.approx(runs[0][2], rel=1e-14)
    assert rel(runs[0][1], runs[4][1]) <= 1e-12
    assert rel(runs[0][0].u, runs[4][0].u) <= 1e-12


def test_out_of_slice_configurations_raise_under_a_mesh(tmp_path):
    s, _ = entry._build(16, 4, dtype=F64, device=CPU)
    lim = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    dm = mesh_of((2, 2))
    args = (s.basis, s.mesh, s.bcs)
    kw = dict(limiter=lim, dtype=F64, device=CPU, device_mesh=dm)
    with pytest.raises(NotImplementedError,
                       match="mask.*slice G, the rest of multi-GPU"):
        Solver(*args, mask=np.ones((4, 16), bool), **kw)
    with pytest.raises(NotImplementedError,
                       match="MOOD.*slice G, the rest of multi-GPU"):
        Solver(make_basis("Pk", 2), s.mesh, s.bcs, method="mood", **kw)
    for form in (dict(post_kernel="xla"), dict(volume_kernel="pallas"),
                 dict(volume_kernel="xla")):
        with pytest.raises(NotImplementedError,
                           match="slice G, the rest of multi-GPU"):
            Solver(*args, **form, **kw)
    with pytest.raises(ValueError, match="divisible"):
        Solver(*args, limiter=lim, dtype=F64, device=CPU,
               device_mesh=device_mesh((3, 1), [CPU] * 3))
    if torch.cuda.device_count() < 2:
        # no fallback to fewer cards, and no silent virtual mesh
        with pytest.raises(RuntimeError, match="visible"):
            device_mesh((1, 2), [torch.device("cuda", 0),
                                 torch.device("cuda", 1)])
        prm = tmp_path / "imp.prm"
        prm.write_text(open("examples/implosion.prm").read())
        if torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="visible"):
                cli.run([str(prm), "--devices", "2", "--max-steps", "0"])
    with pytest.raises(NotImplementedError, match="slice G, the rest of multi-GPU"):
        cli.run(["examples/implosion.prm", "--platform", "cpu", "--devices",
                 "4", "--slices", "2"])
