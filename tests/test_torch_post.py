"""The port's stabilization chain against the JAX package's, in float64 on
the CPU (dflo_tpu_torch.stab and ops.kernels.fused_post_plain /
fused_diag_plain against dflo_tpu.stab, Solver.post_stage and compute_dt).

The input is the DMR initial condition on a 32 x 8 mesh with a 5 %
multiplicative perturbation from a seeded numpy generator: the projected
Mach-10 shock marks cells for the TVB limiter, and its unlimited nodal
interpolant has negative point densities for the positivity limiter.
Tolerance 1e-12 relative to the largest magnitude (round-off of another
evaluation order; no threshold decision sits that close to its threshold on
this input, which the equal-mark assertions check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.driver import LimiterConfig as JaxLimiterConfig
from dflo_tpu.driver import Solver as JaxSolver
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import rk as jrk
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import indicator as jind
from dflo_tpu.stab import limiter as jlim
from dflo_tpu.stab import positivity as jpos
from dflo_tpu_torch import entry, ic, interop
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.ops.contract import as_tensor, basis_reduce
from dflo_tpu_torch.solver import rk as trk
from dflo_tpu_torch.stab import indicator as tind
from dflo_tpu_torch.stab import limiter as tlim
from dflo_tpu_torch.stab import positivity as tpos

NX, NY = 32, 8
TOL = 1e-12
F64 = torch.float64
MESH = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
LIM = dict(beta=2.0, char_lim=True, pos_lim=True)


def dmr_state(p: int, seed: int = 0) -> np.ndarray:
    u = ic.set_initial_condition(make_basis("Qk", p), MESH, entry.dmr_ic,
                                 dtype=F64, device="cpu").numpy()
    rng = np.random.default_rng(seed)
    return u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.fixture(scope="module")
def jax_bcs():
    return graft._build(NX, NY)[0].bcs


def jax_solver(p, jax_bcs, char_lim=True):
    lim = JaxLimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                           char_lim=char_lim, pos_lim=True)
    return JaxSolver(jax_make_basis("Qk", p), MESH, jax_bcs, flux="hllc",
                     limiter=lim, cfl=0.5, dtype=jnp.float64)


@pytest.mark.parametrize("char_lim", (True, False))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_fused_post_plain_with_diag_matches_jax(jax_bcs, p, char_lim):
    js = jax_solver(p, jax_bcs, char_lim)
    u_np = dmr_state(p, seed=p)
    ju = jnp.asarray(u_np)
    ref = np.asarray(jax.jit(js.post_stage)(ju))
    ubar = jspatial.cell_averages(js.basis, ju)
    dt_ref = float(jrk.compute_dt(ubar, MESH, p, 0.5))
    lam_ref = 0.5 / dt_ref / (2 * p + 1)
    bad_ref = bool(jpos.negative_average_flag(ubar))

    basis = make_basis("Qk", p)
    ops = kernels.post_operators(basis, MESH, indicator="density", beta=2.0,
                                 char_lim=char_lim, pos_lim=True, dtype=F64,
                                 device="cpu")
    u = interop.state_from_numpy(u_np, F64, "cpu")
    u1, lam, minq = kernels.fused_post_plain(u, ops, with_diag=True)
    assert rel(ref, u1) <= TOL
    assert rel(lam_ref, lam) <= TOL
    assert bool(~(minq >= tpos.EPS)) == bad_ref
    minq_ref = float(jnp.min(jnp.minimum(ubar[2], jeuler.pressure(ubar))))
    assert rel(minq_ref, minq) <= TOL
    assert torch.equal(kernels.fused_post_plain(u, ops), u1)

    # the input exercises every stage of the chain
    shock, _ = ops.indicator(u, basis_reduce(ops.avg, u))
    assert int((shock > 1.0).sum()) > 0
    nopos = kernels.post_operators(basis, MESH, indicator="density",
                                   beta=2.0, char_lim=char_lim, pos_lim=False,
                                   dtype=F64, device="cpu")
    assert not torch.equal(kernels.fused_post_plain(u, nopos), u1)


@pytest.mark.parametrize("kind", ("density", "energy"))
def test_kxrcf_indicator_matches_jax(kind):
    u_np = dmr_state(2, seed=5)
    jb, tb = jax_make_basis("Qk", 2), make_basis("Qk", 2)
    ju = jnp.asarray(u_np)
    jubar = jspatial.cell_averages(jb, ju)
    js, jj = jax.jit(jind.make_shock_indicator(jb, MESH, kind,
                                               dtype=jnp.float64))(ju, jubar)
    u = interop.state_from_numpy(u_np, F64, "cpu")
    ts, tj = tind.make_shock_indicator(tb, MESH, kind, dtype=F64,
                                       device="cpu")(
        u, basis_reduce(as_tensor(tb.wq2 @ tb.V, F64, "cpu"), u))
    assert rel(js, ts) <= TOL and rel(jj, tj) <= TOL
    assert np.array_equal(np.asarray(js) > 1.0, (ts > 1.0).numpy())
    # u2 is Diot's test on the modal D2 coefficients: Pk at p >= 2 only, as
    # the reference (tests/test_torch_envelope_limiters.py holds it)
    with pytest.raises(ValueError, match="Pk basis"):
        tind.make_shock_indicator(tb, MESH, "u2", dtype=F64, device="cpu")


@pytest.mark.parametrize("per", ((False, False), (True, False),
                                 (False, True), (True, True)))
def test_neighbor_flags_and_diffs_match_jax(per):
    valid_j = jlim.neighbor_valid((NY, NX), *per)
    valid_t = tlim.neighbor_valid((NY, NX), *per)
    assert all(np.array_equal(a, b) for a, b in zip(valid_j, valid_t))
    rng = np.random.default_rng(7)
    ub, dx, dy = (rng.standard_normal((4, NY, NX)) for _ in range(3))
    a = jlim.neighbor_diffs(jnp.asarray(ub), (jnp.asarray(dx), jnp.asarray(dy)),
                            tuple(jnp.asarray(v) for v in valid_j))
    b = tlim.neighbor_diffs(torch.from_numpy(ub),
                            (torch.from_numpy(dx), torch.from_numpy(dy)),
                            tuple(torch.from_numpy(v) for v in valid_t))
    assert all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(a, b))


def test_minmod_matches_jax():
    rng = np.random.default_rng(8)
    a, b, c = (rng.standard_normal(4096) for _ in range(3))
    a[::17] = 0.0
    for Mdx2 in (0.0, 0.3):
        ref = np.asarray(jlim.minmod(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), Mdx2))
        got = tlim.minmod(*(torch.from_numpy(x) for x in (a, b, c)), Mdx2)
        assert np.array_equal(ref, got.numpy())


@pytest.mark.parametrize("char_lim", (True, False))
def test_tvb_limiter_matches_jax(char_lim):
    u_np = dmr_state(2, seed=9)
    jb, tb = jax_make_basis("Qk", 2), make_basis("Qk", 2)
    ju = jnp.asarray(u_np)
    jubar = jspatial.cell_averages(jb, ju)
    marked = np.where(np.random.default_rng(10).uniform(size=(NY, NX)) > 0.3,
                      2.0, 0.0)
    ref = jax.jit(jlim.make_tvb_limiter(jb, MESH, beta=2.0,
                                        char_lim=char_lim,
                                        dtype=jnp.float64))(
        ju, jubar, jnp.asarray(marked))
    u = interop.state_from_numpy(u_np, F64, "cpu")
    got = tlim.make_tvb_limiter(tb, MESH, beta=2.0, char_lim=char_lim,
                                dtype=F64, device="cpu")(
        u, torch.from_numpy(np.array(jubar)), torch.from_numpy(marked))
    assert rel(ref, got) <= TOL
    assert not np.array_equal(np.asarray(ref), u_np)


@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_positivity_matches_jax(dtype):
    """Zhang-Shu with the dtype-aware floors: absolute EPS in f64, relative
    REL_F32 in f32 (held at f32 round-off, 1e-5 relative)."""
    tol = TOL if dtype == "float64" else 1e-5
    tdt = getattr(torch, dtype)
    u_np = dmr_state(2, seed=11).astype(dtype)
    jb, tb = jax_make_basis("Qk", 2), make_basis("Qk", 2)
    ju = jnp.asarray(u_np)
    jubar = jspatial.cell_averages(jb, ju)
    ref = jax.jit(jpos.make_positivity_limiter(jb, MESH, dtype=ju.dtype))(
        ju, jubar)
    u = interop.state_from_numpy(u_np, tdt, "cpu")
    ubar = torch.from_numpy(np.array(jubar))
    got = tpos.make_positivity_limiter(tb, dtype=tdt, device="cpu")(u, ubar)
    assert got.dtype == tdt
    assert rel(ref, got) <= tol
    assert not np.array_equal(np.asarray(ref), u_np)
    er_j, ep_j = jpos.pos_floors(jubar, ju.dtype)
    er_t, ep_t = tpos.pos_floors(ubar, tdt)
    assert rel(er_j, er_t) <= tol and rel(ep_j, ep_t) <= tol
    if dtype == "float32":
        assert float(er_t.min()) > tpos.EPS     # relative, not 1e-13


def test_fused_diag_plain_matches_jax_and_propagates_nan():
    u_np = dmr_state(2, seed=12)
    jb = jax_make_basis("Qk", 2)
    jubar = jspatial.cell_averages(jb, jnp.asarray(u_np))
    lam_ref = 0.5 / float(jrk.compute_dt(jubar, MESH, 2, 0.5)) / 5.0
    ops = kernels.diag_operators(make_basis("Qk", 2), MESH, dtype=F64,
                                 device="cpu")
    u = interop.state_from_numpy(u_np, F64, "cpu")
    lam, minq = kernels.fused_diag_plain(u, ops)
    assert rel(lam_ref, lam) <= TOL
    dt = trk.compute_dt(basis_reduce(ops.avg, u), MESH, 2, 0.5)
    assert rel(jrk.compute_dt(jubar, MESH, 2, 0.5), dt) <= TOL
    assert bool(~(minq >= tpos.EPS)) == bool(jpos.negative_average_flag(jubar))
    assert torch.equal(torch.stack(kernels.fused_diag(u, ops)),
                       torch.stack((lam, minq)))

    # one NaN cell must reach the fatal flag through both diag paths
    u[:, :, NY // 2, NX // 3] = float("nan")
    post = kernels.post_operators(make_basis("Qk", 2), MESH, **LIM,
                                  indicator="density", dtype=F64,
                                  device="cpu")
    _, minq = kernels.fused_diag_plain(u, ops)
    _, _, minq2 = kernels.fused_post_plain(u, post, with_diag=True)
    assert bool(~(minq >= tpos.EPS)) and bool(~(minq2 >= tpos.EPS))
    assert bool(tpos.negative_average_flag(basis_reduce(ops.avg, u)))
