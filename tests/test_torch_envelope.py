"""The fused residual's whole single-card envelope against the JAX package,
on the CPU in float64.

- Degrees 4 and 6 on Qk, GLL and Pk, and three over-integrated bases
  (nq = p + 2: Qk2 and GLL2 on 4 x 4 Gauss points, Pk4 on 6 x 6): the
  port's fused residual (its plain version on the CPU, with its delta
  strips) in its R, u + dt*R and SSP-stage forms against dflo_tpu's
  make_rhs (its XLA residual) and the same blends in numpy, on a smooth
  state with 1 % noise on every DoF, 16 x 8 cells, periodic in x and
  slip walls in y (the strips carry the walls).  Tolerance 1e-12 relative
  to each component's largest magnitude (a component below a millionth of
  the state's largest measured against that millionth); none of these
  cases needs the 1e-11 that Qk's conditioning could at p >= 5: the
  largest difference is 3.0e-14 (GLL2 on 4 x 4 points; Q6 1.8e-14).
- The twelve (flux, source arm) pairs the kernel gained: roe, sw, kfvs
  and kep with gravity (euler.GravitySource on Q1), with an external
  force's planes (euler.ExternalForce on P2) and with isothermal
  well-balancing (GLL2, the potential x + y), against dflo_tpu's residual
  with the same source, 1e-12.  kfvs is held against the reference's fused
  residual (its Pallas kernel in interpret mode), whose erf is the
  Abramowitz-Stegun form (pallas_kernels.py:272-273), once per arm; the
  other fluxes against its XLA residual.
- The routing: "auto" resolves the residual to the kernel for p = 4 and
  for nq = p + 2 (the parent resolved both to the plain residual), the
  post to the kernel on collocated Q4 with TVB and to the plain chain on
  over-integrated Qk (the reference's post_ok); MOOD at p = 7 and a basis
  with more than NQ_MAX points per direction raise NotImplementedError
  naming the ROADMAP section (on the card as well, tests/test_torch_gpu.py);
  MOOD at p 4-6 builds (its steps: tests/test_torch_mood_degrees.py).
- Two configs through both CLIs (tests/test_torch_configs.check_cli_pair,
  every checkpoint within 1e-10): isentropic_vortex.prm at `degree = 4`
  (P4, lxf, limiter none, periodic) at 16 x 16 and rayleigh_taylor.prm
  with `flux = roe` (Q1, the gravity arm with Roe, characteristic TVB) at
  16 x 16, 3 steps each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import ic
from dflo_tpu_torch.driver import LimiterConfig, Solver, _kernel_forms
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs

F64 = torch.float64
TOL = 1e-12
NX, NY = 16, 8
T = 0.37
H, A = 1e-3, 0.75
#: (family, degree, nq or None, flux) of the degree and quadrature cases
BASES = (("Qk", 4, None, "hllc"), ("Qk", 6, None, "lxf"),
         ("Qk_gll", 4, None, "roe"), ("Qk_gll", 6, None, "sw"),
         ("Pk", 4, None, "kep"), ("Pk", 6, None, "lxf"),
         ("Qk", 2, 4, "lxf"), ("Qk_gll", 2, 4, "hllc"), ("Pk", 4, 6, "roe"))
NEW_FLUXES = ("roe", "sw", "kfvs", "kep")
ARMS = ("grav", "force", "wbiso")


def rel(ref, x) -> float:
    """max over components of max|ref - x| / max|ref|, a component's scale
    at least a millionth of the state's largest magnitude."""
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    mags = np.abs(ref).reshape(4, -1).max(1)
    scale = np.maximum(mags, max(1e-6 * mags.max(), 1e-300))
    return float((np.abs(ref - x).reshape(4, -1).max(1) / scale).max())


def smooth_ic(x, y, t=0.0):
    """A smooth moving state with a density bump (torch or jax inputs)."""
    m = jnp if isinstance(x, jnp.ndarray) else torch
    rho = 1.0 + 0.2 * m.exp(-((x - 1.0) ** 2 + (y - 0.5) ** 2) / 0.05)
    p = 1.0 + 0.1 * rho
    return m.stack([0.3 * rho, -0.1 * rho, rho,
                    p / (euler.GAMMA - 1.0)
                    + 0.5 * rho * (0.3 ** 2 + 0.1 ** 2)])


def noisy_state(basis, mesh, seed: int) -> np.ndarray:
    """smooth_ic on the basis with 1 % noise (numpy rng) on every DoF: every
    face carries a jump, every point value stays physical."""
    u = ic.set_initial_condition(basis, mesh, smooth_ic, dtype=F64,
                                 device="cpu").numpy()
    rng = np.random.default_rng(seed)
    scale = np.abs(u).reshape(4, -1).max(1)[:, None, None, None]
    return u + 0.01 * scale * rng.uniform(-1.0, 1.0, u.shape)


def sides(kinds):
    """(port bcs, JAX bcs) with kinds {side: kind}."""
    return ({k: BoundarySide(v) for k, v in kinds.items()},
            {k: jspatial.BoundarySide(v) for k, v in kinds.items()})


PER_X_SLIP_Y = {"W": euler.BC_PERIODIC, "E": euler.BC_PERIODIC,
                "S": euler.BC_SLIP, "N": euler.BC_SLIP}


def check_forms(rhs, u_np, ref, tol=TOL):
    """The fused rhs's R, u + dt*R and SSP-stage forms against the JAX
    residual ref and its blends in numpy."""
    u = torch.from_numpy(u_np)
    strips = rhs.strips(u, T)
    force = rhs.force(T)
    R = kernels.fused_residual(u, *strips, rhs.ops, force=force)
    assert np.isfinite(ref).all()
    assert rel(ref, R) <= tol, rel(ref, R)
    step = kernels.fused_residual(u, *strips, rhs.ops,
                                  dt=torch.tensor(H, dtype=F64), force=force)
    assert rel(u_np + H * ref, step) <= tol
    u_old = np.flip(u_np, -1).copy()
    stage = kernels.fused_residual(u, *strips, rhs.ops,
                                   u_old=torch.from_numpy(u_old),
                                   sc=torch.tensor([A, H], dtype=F64),
                                   force=force)
    assert rel(A * u_old + (1.0 - A) * (u_np + H * ref), stage) <= tol
    return rel(ref, R)


@pytest.mark.parametrize("family, p, nq, flux", BASES)
def test_envelope_residual_matches_jax(family, p, nq, flux):
    mesh, jmesh = (CartesianMesh(NX, NY, 0.0, 2.0, 0.0, 1.0),
                   JMesh(NX, NY, 0.0, 2.0, 0.0, 1.0))
    basis, jbasis = make_basis(family, p, nq), jax_make_basis(family, p, nq)
    assert (basis.K, basis.nq) == (jbasis.K, jbasis.nq)
    u_np = noisy_state(basis, mesh, 10 * p + basis.nq)
    bcs, jbcs = sides(PER_X_SLIP_Y)
    ref = np.asarray(jax.jit(jspatial.make_rhs(jbasis, jmesh, jbcs,
                                               flux=flux,
                                               dtype=jnp.float64))(
        jnp.asarray(u_np), T))
    rhs = make_rhs(basis, mesh, bcs, flux=flux, dtype=F64, device="cpu",
                   volume_kernel="fused")
    # over-integrated nodal and modal bases contract with V in the kernel
    assert (rhs.ops.V is None) == basis.is_nodal_collocated
    check_forms(rhs, u_np, ref)


def jax_grav(x, y, t, W):
    return jeuler.forcing_gravity(W, (0.0, -0.1))


def jax_force(x, y, t, W):
    return jeuler.forcing_external(W, 0.3 * jnp.sin(2.0 * jnp.pi * x)
                                   * jnp.cos(t), -0.2 * y)


#: arm -> (port kwargs of make_rhs, JAX kwargs, basis, boundary kinds)
ARM_SETUPS = {
    "grav": (dict(source=euler.GravitySource(0.0, -0.1)),
             dict(source=jax_grav), ("Qk", 1), PER_X_SLIP_Y),
    "force": (dict(source=euler.ExternalForce(
        lambda x, y, t: (0.3 * torch.sin(2.0 * np.pi * x) * torch.cos(t),
                         -0.2 * y))),
        dict(source=jax_force), ("Pk", 2), PER_X_SLIP_Y),
    "wbiso": (dict(well_balanced="isothermal", potential=lambda x, y: x + y),
              dict(well_balanced="isothermal", potential=lambda x, y: x + y),
              ("Qk_gll", 2), {k: euler.BC_OUTFLOW for k in "WESN"}),
}


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("flux", NEW_FLUXES)
def test_source_arm_with_new_flux_matches_jax(flux, arm):
    kw, jkw, (family, p), kinds = ARM_SETUPS[arm]
    mesh, jmesh = (CartesianMesh(NX, NY, 0.0, 2.0, 0.0, 1.0),
                   JMesh(NX, NY, 0.0, 2.0, 0.0, 1.0))
    basis = make_basis(family, p)
    u_np = noisy_state(basis, mesh, 7)
    bcs, jbcs = sides(kinds)
    jrhs = jspatial.make_rhs(
        jax_make_basis(family, p), jmesh, jbcs, flux=flux,
        dtype=jnp.float64,
        volume_kernel="fused" if flux == "kfvs" else "xla", **jkw)
    # the interpret-mode kernel runs eagerly, the XLA residual jitted
    ref = np.asarray((jrhs if flux == "kfvs" else jax.jit(jrhs))(
        jnp.asarray(u_np), T))
    rhs = make_rhs(basis, mesh, bcs, flux=flux, dtype=F64, device="cpu",
                   volume_kernel="fused", **kw)
    assert (rhs.ops.flux, rhs.ops.source) == (flux, arm)
    check_forms(rhs, u_np, ref)
    assert kernels._residual_form(rhs.ops) == \
        f"fused_residual[{kernels._BASIS_TAG[family]}_{flux}_{arm}_R]"


def test_auto_routes_the_envelope_to_the_kernels():
    """The forms "auto" resolves to, as the reference's vol_ok and post_ok
    (dflo_tpu/driver.py:104-138): the residual kernel for degrees 4-6 and
    any nq up to NQ_MAX, the post kernel on collocated Gauss Qk with TVB."""
    tvb = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    none = LimiterConfig()
    cases = {
        ("Qk", 4, None, "hllc", "tvb"): ("fused", "fused"),
        ("Qk", 6, None, "hllc", "tvb"): ("fused", "fused"),
        ("Qk_gll", 5, None, "roe", "tvb"): ("fused", "xla"),
        ("Pk", 4, None, "lxf", "none"): ("fused", "xla"),
        ("Pk", 6, None, "lxf", "none"): ("fused", "xla"),
        ("Qk", 2, 4, "lxf", "tvb"): ("fused", "xla"),
        ("Qk", 4, 6, "kep", "none"): ("fused", "xla"),
        ("Pk", 2, 4, "sw", "none"): ("fused", "xla"),
    }
    for (family, p, nq, flux, lim), want in cases.items():
        basis = make_basis(family, p, nq)
        cfg = tvb if lim == "tvb" else none
        assert _kernel_forms(basis, flux, "rk", cfg, "auto", "auto") == want
    # the Solver takes those forms: the kernel's operators, the fused post's
    # on collocated Q4, the plain chain off the nodes
    mesh = CartesianMesh(NX, NY, 0.0, 2.0, 0.0, 1.0)
    bcs, _ = sides(PER_X_SLIP_Y)
    s = Solver(make_basis("Qk", 4), mesh, bcs, flux="hllc", limiter=tvb,
               dtype=F64, device="cpu")
    assert s._fused_chain and s.rhs.ops.p == 4
    s = Solver(make_basis("Qk", 2, 4), mesh, bcs, limiter=tvb, dtype=F64,
               device="cpu")
    assert not s._fused_chain and s.rhs.ops.V is not None
    s = Solver(make_basis("Qk", 1), mesh, bcs, flux="roe", limiter=tvb,
               dtype=F64, device="cpu", source=euler.GravitySource(0.0, -1.0))
    assert (s.volume_kernel, s.rhs.ops.source) == ("fused", "grav")


def test_mood_above_p3_and_quadrature_beyond_cap_raise():
    """MOOD above the kernels' degrees (p = 7) and a basis beyond NQ_MAX
    raise at Solver construction (beyond_caps, the bounds of the general
    dims), on the CPU as on the card: neither runs on the plain path
    instead."""
    mesh = CartesianMesh(NX, NY, 0.0, 2.0, 0.0, 1.0)
    bcs, _ = sides(PER_X_SLIP_Y)
    tvb = LimiterConfig(type="TVB", beta=2.0, pos_lim=True)
    with pytest.raises(NotImplementedError,
                       match="the bounds of the general dims"):
        Solver(make_basis("Pk", 7), mesh, bcs, limiter=tvb, dtype=F64,
               device="cpu", method="mood")
    with pytest.raises(NotImplementedError,
                       match="the bounds of the general dims"):
        kernels.pk_post_operators(make_basis("Pk", 7), mesh, dtype=F64,
                                  device="cpu")
    for vk in ("auto", "fused"):
        with pytest.raises(NotImplementedError,
                           match="the bounds of the general dims"):
            Solver(make_basis("Qk", 2, kernels.NQ_MAX + 1), mesh, bcs,
                   dtype=F64, device="cpu", volume_kernel=vk)


def test_mood_builds_at_p4_to_p6():
    """MOOD at p 4-6 builds on the CPU, on the fused residual with the
    sparse candidate and the check kernel's operators, as the reference's
    Solver builds its four MOOD kernels at any degree (dflo_tpu/driver.py:
    280-336)."""
    mesh = CartesianMesh(NX, NY, 0.0, 2.0, 0.0, 1.0)
    bcs, _ = sides(PER_X_SLIP_Y)
    tvb = LimiterConfig(type="TVB", beta=2.0, pos_lim=True)
    for p in (4, 5, 6):
        s = Solver(make_basis("Pk", p), mesh, bcs, limiter=tvb, dtype=F64,
                   device="cpu", method="mood")
        assert s.volume_kernel == "fused" and s._mood_stage.sparse
        assert s._mood_stage.cops.p == s._pk_post_ops.p == p


def test_cli_vortex_p4_matches_jax(tmp_path):
    from test_torch_configs import check_cli_pair, edited
    text = edited("isentropic_vortex", 16, 16,
                  ("set degree = 2", "set degree = 4"))
    res, _, _ = check_cli_pair(text, tmp_path, "Pk", 16, steps=3)
    assert res.solver.basis.degree == 4
    assert res.solver.volume_kernel == "fused"


def test_cli_rayleigh_taylor_roe_matches_jax(tmp_path):
    from test_torch_configs import check_cli_pair, edited
    text = edited("rayleigh_taylor", 16, 16,
                  ("set flux = hllc", "set flux = roe"))
    res, _, _ = check_cli_pair(text, tmp_path, "Qk", 16, steps=3)
    assert (res.solver.rhs.ops.flux, res.solver.rhs.ops.source) == \
        ("roe", "grav")
