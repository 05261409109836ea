"""The port's modal Pk pieces against the JAX package's, in float64 on the
CPU: the basis operators, the L2 initial projection, modal positivity (f64
and f32), the modal TVB limiter, KXRCF on Pk, and the plain versions of the
MOOD slice's kernels (the dense modal residual, the candidate, the modal
positivity, the Pk post and the diag) against the dflo_tpu XLA functions
they replace.

Inputs: the DMR initial condition projected onto P_p on a 32 x 8 mesh with a
5 % multiplicative perturbation from a seeded numpy generator, then the
positivity limiter (the state every stage hands on).  Tolerance 1e-12
relative to the largest magnitude (round-off of another evaluation order);
f32 positivity 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu import ic as jic
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.ops.contract import basis_reduce as jbasis_reduce
from dflo_tpu.solver import rk as jrk
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import indicator as jind
from dflo_tpu.stab import limiter as jlim
from dflo_tpu.stab import positivity as jpos
from dflo_tpu_torch import entry, ic, interop
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.solver.spatial import make_rhs
from dflo_tpu_torch.stab import indicator as tind
from dflo_tpu_torch.stab import limiter as tlim
from dflo_tpu_torch.stab import positivity as tpos

NX, NY = 32, 8
TOL = 1e-12
F64 = torch.float64
MESH = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def pk_state(p: int, seed: int) -> np.ndarray:
    """Perturbed, positivity-limited DMR state on P_p (numpy, f64)."""
    basis = make_basis("Pk", p)
    u = ic.set_initial_condition(basis, MESH, entry.dmr_ic, dtype=F64,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    u = u * torch.from_numpy(1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    mops = kernels.modal_operators(basis, MESH, dtype=F64, device="cpu")
    return kernels.modal_tp_plain(u, None, mops).numpy()


def jax_mean(basis, u):
    """dflo_tpu's full-contraction cell averages of a Pk state."""
    return jbasis_reduce(jnp.asarray(basis.wq2 @ basis.V), jnp.asarray(u))


@pytest.fixture(scope="module")
def jax_bcs():
    return graft._build(NX, NY, method="mood")[0].bcs


_JAX_RHS = {}


def jax_rhs(jax_bcs, p):
    """dflo_tpu's jitted XLA residual on P_p, compiled once per degree."""
    if p not in _JAX_RHS:
        _JAX_RHS[p] = jax.jit(jspatial.make_rhs(
            jax_make_basis("Pk", p), MESH, jax_bcs, flux="hllc",
            dtype=jnp.float64, volume_kernel="xla"))
    return _JAX_RHS[p]


@pytest.mark.parametrize("p", (1, 2, 3))
def test_pk_operators_equal_jax(p):
    from dflo_tpu.stab.positivity import _pos_points as jpts
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    for name in ("V", "Gx", "Gy", "faceV", "wq2", "wq", "mass",
                 "mode_degree"):
        assert np.array_equal(np.asarray(getattr(jb, name)),
                              getattr(tb, name)), name
    assert np.array_equal(jb.eval_at(jpts(p)),
                          tb.eval_at(tpos._pos_points(p)))
    assert tb.K == (p + 1) * (p + 2) // 2 and tb.family == "Pk"


@pytest.mark.parametrize("p", (1, 2, 3))
def test_pk_initial_projection_matches_jax(p):
    jb = jax_make_basis("Pk", p)
    u_j = jic.set_initial_condition(jb, MESH, lambda x, y, t=0.0: jnp.asarray(
        entry.dmr_ic(torch.from_numpy(np.array(x)),
                     torch.from_numpy(np.array(y)), t).numpy()))
    u_t = ic.set_initial_condition(make_basis("Pk", p), MESH, entry.dmr_ic,
                                   dtype=F64, device="cpu")
    assert u_t.shape == (4, jb.K, NY, NX)
    assert rel(u_j, u_t) <= TOL
    if p == 2:     # and the MOOD entry point's initial state
        assert rel(graft._build(NX, NY, method="mood")[1],
                   entry._build(NX, NY, device="cpu", method="mood")[1]) \
            <= TOL


@pytest.mark.parametrize("dtype", ("float64", "float32"))
def test_modal_positivity_matches_jax(dtype):
    tol = TOL if dtype == "float64" else 1e-5
    tdt = getattr(torch, dtype)
    jb, tb = jax_make_basis("Pk", 2), make_basis("Pk", 2)
    rng = np.random.default_rng(3)
    # the unlimited projection, perturbed: negative point densities
    u_np = ic.set_initial_condition(tb, MESH, entry.dmr_ic, dtype=F64,
                                    device="cpu").numpy()
    u_np = (u_np * (1.0 + 0.3 * rng.uniform(-1.0, 1.0, u_np.shape))
            ).astype(dtype)
    ubar = jax_mean(jb, u_np).astype(dtype)
    ref = jax.jit(jpos.make_positivity_limiter(jb, MESH, dtype=ubar.dtype))(
        jnp.asarray(u_np), ubar)
    got = tpos.make_positivity_limiter(tb, dtype=tdt, device="cpu")(
        interop.state_from_numpy(u_np, tdt, "cpu"),
        torch.from_numpy(np.array(ubar)))
    assert got.dtype == tdt and rel(ref, got) <= tol
    assert not np.array_equal(np.asarray(ref), u_np)
    # modal scaling: the means survive
    assert rel(np.asarray(ref)[:, 0], got[:, 0]) <= tol


@pytest.mark.parametrize("char_lim", (True, False))
def test_modal_tvb_limiter_matches_jax(char_lim):
    u_np = pk_state(2, seed=4)
    jb, tb = jax_make_basis("Pk", 2), make_basis("Pk", 2)
    ubar = 1.0 * u_np[:, 0] * float((jb.wq2 @ jb.V)[0])
    marked = np.where(np.random.default_rng(5).uniform(size=(NY, NX)) > 0.3,
                      2.0, 0.0)
    ref = jax.jit(jlim.make_tvb_limiter(jb, MESH, beta=2.0, char_lim=char_lim,
                                        dtype=jnp.float64))(
        jnp.asarray(u_np), jnp.asarray(ubar), jnp.asarray(marked))
    got = tlim.make_tvb_limiter(tb, MESH, beta=2.0, char_lim=char_lim,
                                dtype=F64, device="cpu")(
        torch.from_numpy(u_np), torch.from_numpy(ubar),
        torch.from_numpy(marked))
    assert rel(ref, got) <= TOL
    limited = np.abs(np.asarray(ref) - u_np).max(axis=(0, 1)) > 0
    assert limited.sum() > 0
    # the rebuild keeps [mean, x-slope (mode 1), y-slope (mode p+1)] only
    assert np.all(np.asarray(ref)[:, [2, 4, 5]][..., limited] == 0.0)


def test_kxrcf_on_pk_matches_jax():
    u_np = pk_state(2, seed=6)
    jb, tb = jax_make_basis("Pk", 2), make_basis("Pk", 2)
    jubar = jax_mean(jb, u_np)
    js, jj = jax.jit(jind.make_shock_indicator(jb, MESH, "density",
                                               dtype=jnp.float64))(
        jnp.asarray(u_np), jubar)
    ts, tj = tind.make_shock_indicator(tb, MESH, "density", dtype=F64,
                                       device="cpu")(
        torch.from_numpy(u_np), torch.from_numpy(np.array(jubar)))
    assert rel(js, ts) <= TOL and rel(jj, tj) <= TOL
    assert np.array_equal(np.asarray(js) > 1.0, (ts > 1.0).numpy())
    assert int((ts > 1.0).sum()) > 0


@pytest.mark.parametrize("p", (1, 2, 3))
def test_modal_residual_plain_matches_jax(jax_bcs, p):
    """fused_residual_plain on P_p (V contraction, periodic wrap + delta
    strips) against dflo_tpu's XLA residual, in its R, u + dt*R and
    SSP-stage forms; at P2 through the MOOD solver's own residual."""
    u_np = pk_state(p, seed=2)
    t, dt, a = 0.01, 2.5e-4, 0.75
    R_jax = np.asarray(jax_rhs(jax_bcs, p)(jnp.asarray(u_np), t))
    ts, _ = entry._build(NX, NY, device="cpu", method="mood")
    rhs = ts.rhs if p == 2 else make_rhs(make_basis("Pk", p), MESH, ts.bcs,
                                         flux="hllc", dtype=F64,
                                         device="cpu", volume_kernel="fused")
    u = torch.from_numpy(u_np)
    h = torch.tensor(dt, dtype=F64)
    assert rel(R_jax, rhs(u, t)) <= TOL
    assert rel(u_np + dt * R_jax, rhs.step(u, t, h)) <= TOL
    u_old = pk_state(p, seed=20 + p)
    assert rel(a * u_old + (1.0 - a) * (u_np + dt * R_jax),
               rhs.stage(u, torch.from_numpy(u_old), t, a, h)) <= TOL


@pytest.mark.parametrize("p", (1, 2, 3))
def test_modal_residual_forms_match_plain_rhs(p):
    """For every instantiated degree: the fused residual's plain version
    (its R, u + dt*R and SSP-stage forms) against the port's whole-domain
    plain residual (the strips path against the padded one)."""
    u_np = pk_state(p, seed=p)
    ts, _ = entry._build(NX, NY, device="cpu", method="mood")
    basis = make_basis("Pk", p)
    plain = make_rhs(basis, MESH, ts.bcs, flux="hllc", dtype=F64,
                     device="cpu")
    fused = make_rhs(basis, MESH, ts.bcs, flux="hllc", dtype=F64,
                     device="cpu", volume_kernel="fused")
    u = torch.from_numpy(u_np)
    t, dt, a = 0.01, 2.5e-4, 0.75
    R = plain(u, t)
    assert rel(R, fused(u, t)) <= TOL
    assert rel(u + dt * R, fused.step(u, t, torch.tensor(dt, dtype=F64))) \
        <= TOL
    u_old = torch.from_numpy(pk_state(p, seed=10 + p))
    assert rel(a * u_old + (1.0 - a) * (u + dt * R),
               fused.stage(u, u_old, t, a, torch.tensor(dt, dtype=F64))) \
        <= TOL


@pytest.mark.parametrize("with_deg", (False, True))
def test_modal_pos_plain_matches_jax_chain(with_deg):
    """fused_modal_pos_plain against the XLA chain it replaces: the
    truncation masks of stab/mood.py, then stab/positivity."""
    p = 2
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    rng = np.random.default_rng(7)
    u_np = ic.set_initial_condition(tb, MESH, entry.dmr_ic, dtype=F64,
                                    device="cpu").numpy()
    u_np = u_np * (1.0 + 0.3 * rng.uniform(-1.0, 1.0, u_np.shape))
    deg = rng.integers(1, p + 1, (NY, NX)).astype(np.int32)
    ut = u_np
    if with_deg:
        trunc = np.stack([(jb.mode_degree <= d) for d in range(p + 1)])
        ut = u_np * np.moveaxis(trunc[deg], -1, 0)[None]
    ref = jax.jit(jpos.make_positivity_limiter(jb, MESH, jnp.float64))(
        jnp.asarray(ut), jax_mean(jb, u_np))
    mops = kernels.modal_operators(tb, MESH, dtype=F64, device="cpu")
    got, lam, minq = kernels.fused_modal_pos_plain(
        torch.from_numpy(u_np), mops,
        torch.from_numpy(deg) if with_deg else None, with_diag=True)
    assert rel(ref, got) <= TOL
    dt_ref = float(jrk.compute_dt(jax_mean(jb, u_np), MESH, p, 0.5))
    assert rel(0.5 / dt_ref / (2 * p + 1), lam) <= TOL
    assert bool(~(minq >= tpos.EPS)) == bool(
        jpos.negative_average_flag(jax_mean(jb, u_np)))


def test_candidate_plain_matches_jax_candidate(jax_bcs):
    """The plain sparse candidate with every cell set is dflo_tpu's dense
    candidate(deg) = positivity(truncation(u_pre)) + dt*R; with a cell set
    the other cells keep u_prev bitwise."""
    p = 2
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    u_np = pk_state(p, seed=8)
    rng = np.random.default_rng(9)
    deg = rng.integers(1, p + 1, (NY, NX)).astype(np.int32)
    t, dt = 0.0, 2e-4
    trunc = np.stack([(jb.mode_degree <= d) for d in range(p + 1)])
    ut = jax.jit(jpos.make_positivity_limiter(jb, MESH, jnp.float64))(
        jnp.asarray(u_np * np.moveaxis(trunc[deg], -1, 0)[None]),
        jax_mean(jb, u_np))
    ref = np.asarray(ut + dt * jax_rhs(jax_bcs, p)(ut, t))

    ts, _ = entry._build(NX, NY, device="cpu", method="mood")
    rhs = ts.rhs
    u = torch.from_numpy(u_np)
    degt = torch.from_numpy(deg)
    h = torch.tensor(dt, dtype=F64)
    full = rhs.sparse_candidate(u, torch.zeros_like(u), degt, t, h,
                                torch.ones((NY, NX), dtype=torch.bool))
    assert rel(ref, full) <= TOL
    # the strips of the candidate are those of the limited state
    u_tt = kernels.fused_modal_pos_plain(u, rhs.modal_ops, degt)
    for a, b in zip(rhs.strips(u, t, degt), rhs.strips(u_tt, t)):
        assert torch.equal(a, b)
    cells = torch.from_numpy(rng.uniform(size=(NY, NX)) < 0.3)
    prev = torch.from_numpy(rng.standard_normal(u.shape))
    part = rhs.sparse_candidate(u, prev.clone(), degt, t, h, cells)
    assert torch.equal(part[..., ~cells], prev[..., ~cells])
    assert torch.equal(part[..., cells], full[..., cells])


@pytest.mark.parametrize("char_lim", (True, False))
def test_pk_post_plain_matches_jax_chain(char_lim):
    """fused_pk_post_plain against the XLA chain of dflo_tpu/driver.py
    _mood_rk_step: mode-0 averages, TVB on the marked cells (1e20 there),
    positivity; with diag, compute_dt's wave speed and the fatal flag."""
    p = 2
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    u_np = pk_state(p, seed=10)
    marked = np.random.default_rng(11).uniform(size=(NY, NX)) > 0.4
    avg0 = float((jb.wq2 @ jb.V)[0])
    jl = jlim.make_tvb_limiter(jb, MESH, beta=2.0, char_lim=char_lim,
                               dtype=jnp.float64)
    jp = jpos.make_positivity_limiter(jb, MESH, jnp.float64)

    @jax.jit
    def chain(u, m):
        ubar = avg0 * u[:, 0]
        return jp(jl(u, ubar, jnp.where(m, 1e20, 0.0)), ubar), ubar

    ref, ubar = chain(jnp.asarray(u_np), jnp.asarray(marked))
    ops = kernels.pk_post_operators(tb, MESH, beta=2.0, char_lim=char_lim,
                                    dtype=F64, device="cpu")
    shock = torch.from_numpy(marked).to(F64) * 2.0
    got, lam, minq = kernels.fused_pk_post_plain(torch.from_numpy(u_np),
                                                 shock, ops, with_diag=True)
    assert rel(ref, got) <= TOL
    assert not np.array_equal(np.asarray(ref), u_np)
    dt_ref = float(jrk.compute_dt(ubar, MESH, p, 0.5))
    assert rel(0.5 / dt_ref / (2 * p + 1), lam) <= TOL
    assert torch.equal(kernels.fused_pk_post(torch.from_numpy(u_np), shock,
                                             ops), got)


def test_pk_diag_plain_matches_jax():
    p = 2
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    u_np = pk_state(p, seed=12)
    jubar = jax_mean(jb, u_np)
    ops = kernels.diag_operators(tb, MESH, dtype=F64, device="cpu")
    lam, minq = kernels.fused_diag_plain(torch.from_numpy(u_np), ops)
    assert ops.K == 6
    dt_ref = float(jrk.compute_dt(jubar, MESH, p, 0.5))
    assert rel(0.5 / dt_ref / (2 * p + 1), lam) <= TOL
    assert bool(~(minq >= tpos.EPS)) == bool(
        jpos.negative_average_flag(jubar))


# ---------------------------------------------------------------------------
# modal LxF: the residual's three forms, and RK on Pk (the reference's
# Solver runs it; the port refused it before)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ny", (4, 10))
@pytest.mark.parametrize("p", (1, 2, 3))
def test_modal_lxf_residual_plain_matches_jax(jax_bcs, p, ny):
    """fused_residual_plain with the LxF flux on P_p (the dissipation speed
    from the avg row applied to each side's DoFs, pallas_kernels.py:340,
    :368, :380) against dflo_tpu's XLA residual with flux="lxf", in its R,
    u + dt*R and SSP-stage forms, on the DMR's inflow, outflow, slip and
    farfield sides at ragged ny."""
    mesh = CartesianMesh(NX, ny, 0.0, 4.0, 0.0, 1.0)
    basis = make_basis("Pk", p)
    rng = np.random.default_rng(30 + p)
    u = ic.set_initial_condition(basis, mesh, entry.dmr_ic, dtype=F64,
                                 device="cpu")
    u = u * torch.from_numpy(1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    mops = kernels.modal_operators(basis, mesh, dtype=F64, device="cpu")
    u = kernels.modal_tp_plain(u, None, mops)
    u_np = u.numpy()
    t, dt, a = 0.01, 2.5e-4, 0.75
    R_jax = np.asarray(jax.jit(jspatial.make_rhs(
        jax_make_basis("Pk", p), mesh, jax_bcs, flux="lxf",
        dtype=jnp.float64, volume_kernel="xla"))(jnp.asarray(u_np), t))
    ts, _ = entry._build(NX, ny, device="cpu", method="mood")
    rhs = make_rhs(basis, mesh, ts.bcs, flux="lxf", dtype=F64, device="cpu",
                   volume_kernel="fused")
    assert rhs.ops.flux == "lxf" and rhs.ops.modal
    h = torch.tensor(dt, dtype=F64)
    assert rel(R_jax, rhs(u, t)) <= TOL
    assert rel(u_np + dt * R_jax, rhs.step(u, t, h)) <= TOL
    u_old = rng.standard_normal(u_np.shape) * 0.01 + u_np
    assert rel(a * u_old + (1.0 - a) * (u_np + dt * R_jax),
               rhs.stage(u, torch.from_numpy(u_old), t, a, h)) <= TOL


def pk_rk_solvers(p: int, flux: str, ny: int = NY, **lim):
    """(dflo_tpu Solver, port Solver, projected DMR IC as numpy) of RK on
    P_p on the DMR sides, CFL 0.5, f64, the limiter lim."""
    from dflo_tpu.driver import LimiterConfig as JLim
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    mesh = CartesianMesh(NX, ny, 0.0, 4.0, 0.0, 1.0)
    jbcs = graft._build(NX, ny, method="mood")[0].bcs
    tbcs = entry._build(NX, ny, device="cpu", method="mood")[0].bcs
    js = JSolver(jax_make_basis("Pk", p), mesh, jbcs, flux=flux,
                 limiter=JLim(**lim), cfl=0.5, dtype=jnp.float64,
                 method="rk")
    ts = Solver(make_basis("Pk", p), mesh, tbcs, flux=flux,
                limiter=LimiterConfig(**lim), cfl=0.5, dtype=F64,
                device="cpu", method="rk")
    u0 = ic.set_initial_condition(ts.basis, mesh, entry.dmr_ic, dtype=F64,
                                  device="cpu").numpy()
    return js, ts, u0


@pytest.mark.parametrize("p, flux, lim", [
    (2, "hllc", dict(type="TVB", shock_indicator="limiter", beta=2.0,
                     char_lim=True)),
    (2, "lxf", dict(type="TVB", shock_indicator="density", beta=2.0,
                    char_lim=True, pos_lim=True)),
    (1, "lxf", dict(type="TVB", shock_indicator="limiter", beta=2.0,
                    char_lim=True))])
def test_pk_rk_solver_matches_jax(p, flux, lim):
    """RK on the modal Pk basis (ROADMAP queue 3, fault 1): the port's
    Solver(method="rk") on P_p, its post the plain modal chain (no fused
    post exists for it in either package) and its diag the Pk diag,
    against dflo_tpu's Solver: the post-staged IC and three steps (dt, the
    fatal flag, the state) to 1e-10."""
    js, ts, u0 = pk_rk_solvers(p, flux, **lim)
    assert (ts.volume_kernel, ts.post_kernel) == ("fused", "xla")
    uj = jax.jit(js.post_stage)(jnp.asarray(u0))
    ut = ts.post_stage(torch.from_numpy(u0))
    assert rel(uj, ut) <= 1e-10
    tj = tt = 0.0
    for _ in range(3):
        uj, dtj, badj, _ = js._step(uj, tj, 1.0)
        ut, dtt, badt, _ = ts._step(ut, tt, 1.0)
        assert float(dtt) == pytest.approx(float(dtj), rel=1e-12)
        assert bool(badt) == bool(badj) is False
        tj += float(dtj)
        tt += float(dtt)
        assert rel(uj, ut) <= 1e-10
    # the chunked loop (the diag of the step's result carries the wave
    # speed) lands where the stepwise loop did
    un, t3, n, bad, _ = ts._multi_step(3)(ts.post_stage(torch.from_numpy(u0)),
                                          0.0, 1.0)
    assert int(n) == 3 and not bool(bad)
    assert float(t3) == pytest.approx(tt, rel=1e-14)
    assert rel(ut, un) <= 1e-14
