"""The rest of the physics envelope against the JAX package, in float64 on
the CPU: the pressure boundary kind, the streamline eigenvectors and the
entropy variables, the minmax limiter, TVB's angular-momentum option, the
u2 and residual indicators and the full mass matrix (dflo_tpu_torch against
dflo_tpu, the same numpy inputs through both).

- The pressure side: make_rhs with a pressure outlet on E (and a segmented
  S side whose second segment is a pressure side) against dflo_tpu's
  make_rhs, the plain form and the kernel's (its plain version here: the
  strips carry the side), 1e-12 relative.  The residual tests take the
  shocked state after the port's positivity limiter: on the unlimited
  shock the JAX package's jitted and eager residuals differ by 6e-11
  (ROADMAP, "Faults found").
- The limiters and indicators on a shocked state (the DMR's Mach-10 shock,
  5 % multiplicative noise from a seeded generator) and a smooth one (a
  sine wave in density and velocity): 1e-12 relative per component, equal
  marks (the cells each limiter rewrites, the cells each indicator marks).
- make_rhs with mass_matrix="full" on GLL2 and Q2, 1e-12 relative (on
  Gauss-collocated Q2 the consistent mass is the lumped one).
- Three Solver steps each of minmax Q2 (characteristic, density indicator,
  positivity), TVB with the u2 indicator on P2, TVB with angular momentum
  on P1 and TVB with the residual indicator on Q2, against three calls of
  dflo_tpu's jitted Solver._step, 1e-12 relative, equal dt and fatal flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import ic as jic
from dflo_tpu.driver import LimiterConfig as JLim
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import indicator as jind
from dflo_tpu.stab import limiter as jlim
from dflo_tpu_torch import entry, ic
from dflo_tpu_torch.driver import LimiterConfig
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.ops.contract import as_tensor, basis_reduce
from dflo_tpu_torch.physics import euler as teuler
from dflo_tpu_torch.solver import spatial as tspatial
from dflo_tpu_torch.stab import indicator as tind
from dflo_tpu_torch.stab import limiter as tlim
from dflo_tpu_torch.stab import positivity as tpos

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-12
MESH = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
JMESH = JMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
#: the free stream's pressure at the outlet (energy slot), a pressure-side
#: value that differs from the outgoing state's
P_OUT = 1.0


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def smooth_ic(x, y, t=0.0):
    """A sine wave in density and velocity at unit pressure."""
    lib = torch if isinstance(x, torch.Tensor) else jnp
    rho = 1.0 + 0.2 * lib.sin(np.pi * x) * lib.cos(2.0 * np.pi * y)
    vx = 0.5 + 0.1 * lib.cos(np.pi * x)
    vy = 0.2 * lib.sin(2.0 * np.pi * y)
    return lib.stack([rho * vx, rho * vy, rho,
                      1.0 / 0.4 + 0.5 * rho * (vx * vx + vy * vy)])


def state(family: str, p: int, kind: str, seed: int = 0) -> np.ndarray:
    """The shocked (DMR, 5 % noise) or smooth state on MESH, numpy."""
    fn = entry.dmr_ic if kind == "shocked" else smooth_ic
    u = ic.set_initial_condition(make_basis(family, p), MESH, fn, dtype=F64,
                                 device="cpu").numpy()
    if kind == "shocked":
        rng = np.random.default_rng(seed)
        u = u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    return u


def limited(family: str, p: int, u: np.ndarray) -> np.ndarray:
    """u after the port's Zhang-Shu limiter: the residual tests take a
    positive state (on the unlimited shock JAX's jitted and eager residuals
    differ by 6e-11, ROADMAP "Faults found")."""
    tb = make_basis(family, p)
    ut = torch.from_numpy(u)
    return tpos.make_positivity_limiter(tb, dtype=F64, device="cpu")(
        ut, basis_reduce(as_tensor(tb.wq2 @ tb.V, F64, "cpu"), ut)).numpy()


def averages(family, p, u):
    """(JAX, port) cell averages of a numpy state."""
    jb, tb = jax_make_basis(family, p), make_basis(family, p)
    ja = jspatial.cell_averages(jb, jnp.asarray(u))
    ta = basis_reduce(as_tensor(tb.wq2 @ tb.V, F64, "cpu"),
                      torch.from_numpy(u))
    return ja, ta


def jax_dmr_bcs(east=None):
    inflow = jax_inflow()
    return dict(W=jspatial.BoundarySide(jeuler.BC_INFLOW, inflow),
                E=east or jspatial.BoundarySide(jeuler.BC_OUTFLOW),
                S=jspatial.BoundarySide(jeuler.BC_SLIP),
                N=jspatial.BoundarySide(jeuler.BC_FARFIELD, inflow))


def jax_inflow():
    def inflow(x, y, t):
        return jnp.stack([jnp.full_like(x, v) for v in
                          entry.POST_CONSERVED])
    return inflow


def jax_pressure(x, y, t):
    z = jnp.zeros_like(x)
    return jnp.stack([z, z, z, z + P_OUT])


def torch_pressure(x, y, t):
    z = torch.zeros_like(x)
    return torch.stack([z, z, z, z + P_OUT])


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------

def test_streamline_eigen_and_entropy_match_jax():
    rng = np.random.default_rng(3)
    n = 256
    rho = rng.uniform(0.2, 8.0, n)
    vx = rng.uniform(-8.0, 8.0, n)
    vy = rng.uniform(-5.0, 5.0, n)
    vx[:8] = vy[:8] = 0.0                 # stagnant: atan2(0, 0) = 0
    vy[8:16] = 0.0                        # along x, both signs
    p = rng.uniform(0.1, 120.0, n)
    U = np.stack([rho * vx, rho * vy, rho,
                  p / 0.4 + 0.5 * rho * (vx * vx + vy * vy)])
    ju, tu = jnp.asarray(U), torch.from_numpy(U)
    for a, b in zip(jeuler.streamline_eigen_matrices(ju),
                    teuler.streamline_eigen_matrices(tu)):
        assert rel(a, b) <= 1e-13
    kx, ky = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    for a, b in zip(jeuler.eigen_matrices_dir(ju, jnp.asarray(kx),
                                              jnp.asarray(ky)),
                    teuler.eigen_matrices_dir(tu, torch.from_numpy(kx),
                                              torch.from_numpy(ky))):
        assert rel(a, b) <= 1e-13
    assert rel(jeuler.entropy_var(ju), teuler.entropy_var(tu)) <= 1e-13


@pytest.mark.parametrize("family,p", (("Qk", 1), ("Pk", 2)))
def test_pressure_side_residual_matches_jax(family, p):
    """A pressure outlet on E and a segmented S (slip, then a pressure side
    from x = 2): the plain residual and the kernel form's plain version
    against dflo_tpu's make_rhs, 1e-12."""
    jb, tb = jax_make_basis(family, p), make_basis(family, p)
    seg = (np.arange(NX) >= NX // 2).astype(np.int32)
    jbcs = jax_dmr_bcs(jspatial.BoundarySide(jeuler.BC_PRESSURE,
                                             jax_pressure))
    jbcs["S"] = jspatial.SegmentedSide(seg, (
        jspatial.BoundarySide(jeuler.BC_SLIP),
        jspatial.BoundarySide(jeuler.BC_PRESSURE, jax_pressure)))
    tbcs = dict(entry._build(NX, NY, device="cpu")[0].bcs,
                E=tspatial.BoundarySide(teuler.BC_PRESSURE, torch_pressure),
                S=tspatial.SegmentedSide(seg, (
                    tspatial.BoundarySide(teuler.BC_SLIP),
                    tspatial.BoundarySide(teuler.BC_PRESSURE,
                                          torch_pressure))))
    u = limited(family, p, state(family, p, "shocked", seed=1))
    ref = jax.jit(jspatial.make_rhs(jb, JMESH, jbcs, flux="hllc",
                                    dtype=jnp.float64))(jnp.asarray(u), 0.0)
    ut = torch.from_numpy(u)
    for form in ("xla", "fused"):
        got = tspatial.make_rhs(tb, MESH, tbcs, flux="hllc", dtype=F64,
                                device="cpu", volume_kernel=form)(ut, 0.0)
        assert rel(ref, got) <= TOL, form
    # the pressure side changes the residual next to it
    out = tspatial.make_rhs(tb, MESH, dict(tbcs, E=tspatial.BoundarySide(
        teuler.BC_OUTFLOW)), flux="hllc", dtype=F64, device="cpu")(ut, 0.0)
    assert not torch.equal(out[..., -1], got[..., -1])


# ---------------------------------------------------------------------------
# limiters and indicators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("shocked", "smooth"))
@pytest.mark.parametrize("char_lim", (False, True))
def test_minmax_limiter_matches_jax(char_lim, kind):
    u = state("Qk", 2, kind, seed=2)
    ja, ta = averages("Qk", 2, u)
    marked = np.full((NY, NX), 2.0)
    jl = jlim.make_minmax_limiter(jax_make_basis("Qk", 2), JMESH,
                                  char_lim=char_lim, dtype=jnp.float64)
    tl = tlim.make_minmax_limiter(make_basis("Qk", 2), MESH,
                                  char_lim=char_lim, dtype=F64, device="cpu")
    ref = np.asarray(jl(jnp.asarray(u), ja, jnp.asarray(marked)))
    got = tl(torch.from_numpy(u), ta, torch.from_numpy(marked))
    assert rel(ref, got) <= TOL
    jmark = (ref != u).any(axis=(0, 1))
    assert np.array_equal(jmark, (got.numpy() != u).any(axis=(0, 1)))
    if kind == "shocked":
        assert 0 < jmark.sum() < NX * NY          # some cells, not all


@pytest.mark.parametrize("family,p", (("Qk", 2), ("Pk", 1), ("Pk", 2)))
def test_tvb_angular_momentum_matches_jax(family, p):
    u = state(family, p, "shocked", seed=3)
    ja, ta = averages(family, p, u)
    marked = np.full((NY, NX), 2.0)
    kw = dict(beta=2.0, char_lim=True, conserve_angular_momentum=True)
    ref = np.asarray(jlim.make_tvb_limiter(
        jax_make_basis(family, p), JMESH, dtype=jnp.float64, **kw)(
            jnp.asarray(u), ja, jnp.asarray(marked)))
    tb = make_basis(family, p)
    got = tlim.make_tvb_limiter(tb, MESH, dtype=F64, device="cpu", **kw)(
        torch.from_numpy(u), ta, torch.from_numpy(marked))
    plain = tlim.make_tvb_limiter(tb, MESH, beta=2.0, char_lim=True,
                                  dtype=F64, device="cpu")(
        torch.from_numpy(u), ta, torch.from_numpy(marked))
    assert rel(ref, got) <= TOL
    assert not torch.equal(got, plain)           # the option acts


@pytest.mark.parametrize("kind", ("shocked", "smooth"))
def test_u2_and_residual_indicators_match_jax(kind):
    # u2 on P2
    u = state("Pk", 2, kind, seed=4)
    ja, ta = averages("Pk", 2, u)
    js, _ = jind.make_shock_indicator(jax_make_basis("Pk", 2), JMESH, "u2",
                                      dtype=jnp.float64)(jnp.asarray(u), ja)
    ts, _ = tind.make_shock_indicator(make_basis("Pk", 2), MESH, "u2",
                                      dtype=F64, device="cpu")(
        torch.from_numpy(u), ta)
    assert np.array_equal(np.asarray(js), ts.numpy())
    if kind == "shocked":
        assert 0 < int((ts > 1).sum()) < NX * NY
    # residual on Q2: the RMS of du/dt, marked above 1e-12
    u = limited("Qk", 2, state("Qk", 2, kind, seed=5))
    ja, ta = averages("Qk", 2, u)
    jb, tb = jax_make_basis("Qk", 2), make_basis("Qk", 2)
    jrhs = jspatial.make_rhs(jb, JMESH, jax_dmr_bcs(), flux="hllc",
                             dtype=jnp.float64)
    trhs = tspatial.make_rhs(tb, MESH, entry._build(NX, NY, device="cpu")[
        0].bcs, flux="hllc", dtype=F64, device="cpu", volume_kernel="fused")
    js, jr = jind.make_shock_indicator(jb, JMESH, "residual",
                                       dtype=jnp.float64, rhs=jrhs)(
        jnp.asarray(u), ja, 0.0)
    ts, tr = tind.make_shock_indicator(tb, MESH, "residual", dtype=F64,
                                       device="cpu", rhs=trhs)(
        torch.from_numpy(u), ta, 0.0)
    assert rel(jr, tr) <= TOL
    assert np.array_equal(np.asarray(js), ts.numpy())
    with pytest.raises(ValueError, match="rhs"):
        tind.make_shock_indicator(tb, MESH, "residual", dtype=F64,
                                  device="cpu")


@pytest.mark.parametrize("family", ("Qk_gll", "Qk"))
def test_full_mass_rhs_matches_jax(family):
    jb, tb = jax_make_basis(family, 2), make_basis(family, 2)
    u = limited(family, 2, state(family, 2, "shocked", seed=6))
    ref = jax.jit(jspatial.make_rhs(jb, JMESH, jax_dmr_bcs(), flux="hllc",
                                    dtype=jnp.float64,
                                    mass_matrix="full"))(jnp.asarray(u), 0.0)
    bcs = entry._build(NX, NY, device="cpu")[0].bcs
    got = tspatial.make_rhs(tb, MESH, bcs, flux="hllc", dtype=F64,
                            device="cpu", mass_matrix="full")(
        torch.from_numpy(u), 0.0)
    assert rel(ref, got) <= TOL
    lumped = tspatial.make_rhs(tb, MESH, bcs, flux="hllc", dtype=F64,
                               device="cpu")(torch.from_numpy(u), 0.0)
    # GLL's lumped mass is inexact, so the option acts; Gauss-collocated
    # Qk's consistent mass is diagonal (its quadrature is exact for it)
    if family == "Qk_gll":
        assert rel(got.numpy(), lumped) > 1e-6
    else:
        assert rel(got.numpy(), lumped) <= TOL
    with pytest.raises(ValueError, match="diagonal-mass"):
        tspatial.make_rhs(tb, MESH, bcs, dtype=F64, device="cpu",
                          volume_kernel="fused", mass_matrix="full")


# ---------------------------------------------------------------------------
# three Solver steps
# ---------------------------------------------------------------------------

TVB = dict(type="TVB", shock_indicator="density", beta=2.0, char_lim=True,
           pos_lim=True)
SOLVER_CASES = {
    "minmax_q2": ("Qk", 2, dict(TVB, type="minmax"), {}),
    "u2_p2": ("Pk", 2, dict(TVB, shock_indicator="u2"), {}),
    "angmom_p1": ("Pk", 1, dict(TVB, conserve_angular_momentum=True), {}),
    "residual_q2": ("Qk", 2, dict(TVB, shock_indicator="residual"), {}),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_steps_match_jax(case):
    family, p, lim, kw = SOLVER_CASES[case]
    js = JSolver(jax_make_basis(family, p), JMESH, jax_dmr_bcs(),
                 flux="hllc", limiter=JLim(**lim), cfl=0.5,
                 dtype=jnp.float64, **kw)
    ts, u0 = entry._build(NX, NY, dtype=F64, device="cpu", family=family,
                          degree=p, limiter=LimiterConfig(**lim), **kw)
    # the kernels' route: the residual kernel and the plain post chain
    assert ts.volume_kernel == "fused" and ts.post_kernel == "xla"
    assert not ts._fused_chain
    ju = jax.jit(js.post_stage)(jnp.asarray(u0.numpy()))
    tu = ts.post_stage(u0)
    assert rel(ju, tu) <= TOL
    t = 0.0
    for k in range(3):
        ju, jdt, jbad, _ = js._step(ju, t, 1.0)
        tu, tdt, tbad, _ = ts._step(tu, t, 1.0)
        t += float(jdt)
        assert abs(float(tdt) - float(jdt)) <= 1e-13 * float(jdt), k
        assert rel(ju, tu) <= TOL, k
        assert not bool(jbad) and not bool(tbad)
    assert bool(torch.isfinite(tu).all())


def test_jax_ic_of_the_smooth_state_matches():
    """The smooth state's projection is the same in both packages (the
    limiter cases above feed the port's projection to both)."""
    jb = jax_make_basis("Pk", 2)
    ju = jic.set_initial_condition(jb, JMESH, smooth_ic)
    assert rel(ju, state("Pk", 2, "smooth")) <= 1e-13
