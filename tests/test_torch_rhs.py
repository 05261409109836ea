"""The port's DG residual against the JAX package's, in float64 on the CPU.

fused_residual_plain is the plain version of the fused residual kernel: the
periodic-wrap residual plus the O(boundary) delta strips.  On the DMR
boundaries (inflow W, outflow E, slip S, farfield N) at 32 x 8 it must equal
both the port's plain residual and dflo_tpu's make_rhs(volume_kernel="xla")
to 1e-12 relative to max|R|, in its residual form and in its SSP-stage form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu import ic as jic
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import entry, ic, interop
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import BoundarySide, cell_averages, make_rhs

NX, NY = 32, 8
TOL = 1e-12
F64 = torch.float64
MESH = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def dmr():
    """(jax solver, port solver) of the DMR configuration at 32 x 8."""
    js, _ = graft._build(NX, NY)
    ts, _ = entry._build(NX, NY, dtype=F64, device="cpu")
    return js, ts


def perturbed_dmr_state(p: int, seed: int) -> np.ndarray:
    """The DMR initial condition on Q_p with a 5 % multiplicative
    perturbation (numpy rng), so every face carries a jump, then the
    stabilization chain (TVB + positivity), as the solver hands states to
    the residual.  The unlimited nodal interpolant of the shock has negative
    face densities, where HLLC's floors make the flux ill-conditioned (the
    JAX package's jit and eager results differ there by 1e-10)."""
    basis = make_basis("Qk", p)
    u = ic.set_initial_condition(basis, MESH, entry.dmr_ic, dtype=F64,
                                 device="cpu").numpy()
    rng = np.random.default_rng(seed)
    u = u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    post = kernels.post_operators(basis, MESH, indicator="density", beta=2.0,
                                  char_lim=True, pos_lim=True, dtype=F64,
                                  device="cpu")
    return kernels.fused_post_plain(torch.from_numpy(u), post).numpy()


PERIODIC = {k: BoundarySide(euler.BC_PERIODIC) for k in "WESN"}


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def jax_rhs(p, js, bcs=None):
    return jax.jit(jspatial.make_rhs(jax_make_basis("Qk", p), js.mesh,
                                     bcs or js.bcs, flux="hllc",
                                     dtype=jnp.float64, volume_kernel="xla"))


@pytest.mark.parametrize("p", (1, 2, 3))
def test_residual_forms_match_plain_rhs_and_jax(dmr, p):
    js, ts = dmr
    basis = make_basis("Qk", p)
    u_np = perturbed_dmr_state(p, seed=p)
    u = interop.state_from_numpy(u_np, F64, "cpu")
    t = 0.01
    R_jax = np.asarray(jax_rhs(p, js)(jnp.asarray(u_np), t))

    plain = make_rhs(basis, ts.mesh, ts.bcs, flux="hllc", dtype=F64,
                     device="cpu")
    fused = make_rhs(basis, ts.mesh, ts.bcs, flux="hllc", dtype=F64,
                     device="cpu", volume_kernel="fused")
    R_plain = plain(u, t)
    R_wrap = kernels.fused_residual_plain(u, *fused.strips(u, t), fused.ops)
    assert rel(R_jax, R_plain) <= TOL
    assert rel(R_jax, R_wrap) <= TOL
    assert rel(R_jax, fused(u, t)) <= TOL

    # the SSP-stage form a*u_old + (1-a)*(u + dt*R)
    u_old = interop.state_from_numpy(perturbed_dmr_state(p, seed=10 + p), F64,
                                     "cpu")
    a, dt = 0.75, 2.5e-4
    ref = a * u_old.numpy() + (1.0 - a) * (u_np + dt * R_jax)
    sc = torch.tensor([a, dt], dtype=F64)
    S = kernels.fused_residual_plain(u, *fused.strips(u, t), fused.ops,
                                     u_old=u_old, sc=sc)
    assert rel(ref, S) <= TOL
    assert rel(ref, fused.stage(u, u_old, t, a, torch.tensor(dt, dtype=F64))) \
        <= TOL


def test_strips_vanish_on_periodic_sides_and_carry_the_boundary(dmr):
    _, ts = dmr
    basis = make_basis("Qk", 2)
    u = interop.state_from_numpy(perturbed_dmr_state(2, seed=3), F64, "cpu")
    per = make_rhs(basis, ts.mesh, PERIODIC, flux="hllc", dtype=F64,
                   device="cpu", volume_kernel="fused")
    for s in per.strips(u, 0.0):
        assert float(s.abs().max()) == 0.0
    dfw, dfe, dfs, dfn = ts.rhs.strips(u, 0.0)
    assert tuple(dfw.shape) == tuple(dfe.shape) == (4, 3, NY)
    assert tuple(dfs.shape) == tuple(dfn.shape) == (4, 3, NX)
    assert all(float(s.abs().max()) > 0.0 for s in (dfw, dfe, dfs, dfn))


@pytest.mark.parametrize("p", (2,))
def test_periodic_residual_matches_jax(dmr, p):
    js, ts = dmr
    jbcs = {k: jspatial.BoundarySide(jeuler.BC_PERIODIC) for k in "WESN"}
    u_np = perturbed_dmr_state(p, seed=20 + p)
    u = interop.state_from_numpy(u_np, F64, "cpu")
    R_jax = np.asarray(jax_rhs(p, js, jbcs)(jnp.asarray(u_np), 0.0))
    fused = make_rhs(make_basis("Qk", p), ts.mesh, PERIODIC, flux="hllc",
                     dtype=F64, device="cpu", volume_kernel="fused")
    assert rel(R_jax, fused(u, 0.0)) <= TOL


@pytest.mark.parametrize("p", (1, 2, 3))
def test_free_stream_f64(dmr, p):
    """A uniform state on a periodic mesh: max|du/dt| < 1e-12 through the
    fused residual's plain version and the plain residual."""
    _, ts = dmr
    basis = make_basis("Qk", p)
    rho, vx, vy, pr = 1.4, 0.7, -0.3, 1.0
    w = torch.tensor([rho * vx, rho * vy, rho,
                      pr / (euler.GAMMA - 1.0) + 0.5 * rho * (vx**2 + vy**2)],
                     dtype=F64)
    u = w[:, None, None, None].expand(4, basis.K, NY, NX).contiguous()
    for form in ("xla", "fused"):
        rhs = make_rhs(basis, ts.mesh, PERIODIC, flux="hllc", dtype=F64,
                       device="cpu", volume_kernel=form)
        assert float(rhs(u, 0.0).abs().max()) < 1e-12


def test_cpu_wrapper_takes_the_plain_version(dmr):
    _, ts = dmr
    u = interop.state_from_numpy(perturbed_dmr_state(2, seed=4), F64, "cpu")
    kernels.reset_launch_counts()
    strips = ts.rhs.strips(u, 0.0)
    a = kernels.fused_residual(u, *strips, ts.rhs.ops)
    b = kernels.fused_residual_plain(u, *strips, ts.rhs.ops)
    assert torch.equal(a, b)
    assert kernels.launch_counts()["fused_residual"] == 0
    with pytest.raises(ValueError):
        kernels.fused_residual(u, *strips, ts.rhs.ops, u_old=u)


def test_initial_condition_and_averages_match_jax(dmr):
    js, ts = dmr
    _, u_jax = graft._build(NX, NY)
    u = entry._build(NX, NY, dtype=F64, device="cpu")[1]
    assert rel(np.asarray(u_jax), u) <= 1e-15
    ub_j = jspatial.cell_averages(js.basis, u_jax)
    assert rel(ub_j, cell_averages(ts.basis, u)) <= 1e-14
    assert rel(ub_j, ts.cell_averages(u)) <= 1e-14
    # the JAX package's IC setter on the port's callable gives the same DoFs
    u2 = jic.set_initial_condition(js.basis, js.mesh, graft_dmr_ic_numpy)
    assert rel(np.asarray(u2), u) <= 1e-15


def graft_dmr_ic_numpy(x, y, t=0.0):
    out = entry.dmr_ic(torch.from_numpy(np.array(x)),
                       torch.from_numpy(np.array(y)), t)
    return jnp.asarray(out.numpy())
