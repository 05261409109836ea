"""Body forces and well-balanced gravity of the port against the JAX
package, in float64 on the CPU.

- The residual with a body force (euler.GravitySource, and an
  euler.ExternalForce f = (0.3 sin(2 pi x) cos t, -0.2 y)) on Qk2 and Pk2,
  periodic and slip-walled, in the port's plain ("xla") form and in the
  plain version of its fused kernel, against dflo_tpu's make_rhs(source=...)
  (tests/test_pallas.py:325): 1e-12 relative to max|R|.
- The isothermal (plain and fused forms) and polytropic (plain) well-balanced
  residuals on a perturbed hydrostatic state on GLL2: 1e-12.
- The hydrostatic states stay put through 25 steps at 16 x 16 (isothermal
  p = 1, 2; polytropic p = 2): drift below 5e-13, tests/test_gravity.py's
  oracle; the naive pointwise source drifts above 1e-8 instead.
- Three Rayleigh-Taylor-like TVB steps (Qk2, gravity, periodic x, slip y)
  and three GLL2 TVB steps (the cell-wise rt_gll IC, characteristic TVB)
  through Solver against dflo_tpu's Solver: 1e-11.
- The refusals: a source with well-balancing, polytropic or a generic
  callable with volume_kernel="fused", MOOD with a source, a source under a
  device mesh; and "auto" resolving each source to its form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import ic as jic
from dflo_tpu.driver import LimiterConfig as JLimiterConfig
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import ic
from dflo_tpu_torch.driver import LimiterConfig, Solver, _kernel_forms
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel.sharding import device_mesh
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs

F64 = torch.float64
TOL = 1e-12
DRIFT = 5e-13          # tests/test_gravity.py:35, :75
T = 0.37


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def sides(kind, values=None):
    return ({k: BoundarySide(kind, values) for k in "WESN"},
            {k: jspatial.BoundarySide(kind, values) for k in "WESN"})


def jax_grav(x, y, t, W):
    return jeuler.forcing_gravity(W, (0.0, -0.1))


def jax_extf(x, y, t, W):
    return jeuler.forcing_external(W, 0.3 * jnp.sin(2.0 * jnp.pi * x)
                                   * jnp.cos(t), -0.2 * y)


SOURCES = {
    "gravity": (euler.GravitySource(0.0, -0.1), jax_grav),
    "force": (euler.ExternalForce(
        lambda x, y, t: (0.3 * torch.sin(2.0 * np.pi * x) * torch.cos(t),
                         -0.2 * y)), jax_extf),
}


def smooth_ic(x, y, t=0.0):
    """tests/test_pallas.py:352's smooth state, for numpy/torch/jax alike."""
    m = jnp if isinstance(x, jnp.ndarray) else torch
    rho = 1.0 + 0.2 * m.exp(-((x - 1.0) ** 2 + (y - 0.5) ** 2) / 0.05)
    p = 1.0 + 0.1 * rho
    return m.stack([0.3 * rho, -0.1 * rho, rho,
                    p / (euler.GAMMA - 1.0)
                    + 0.5 * rho * (0.3 ** 2 + 0.1 ** 2)])


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("family", ("Qk", "Pk"))
def test_body_force_residual_matches_jax(family, source):
    mesh, jmesh = CartesianMesh(16, 8, 0.0, 2.0, 0.0, 1.0), \
        JMesh(16, 8, 0.0, 2.0, 0.0, 1.0)
    basis, jbasis = make_basis(family, 2), jax_make_basis(family, 2)
    u = ic.set_initial_condition(basis, mesh, smooth_ic, dtype=F64,
                                 device="cpu")
    src, jsrc = SOURCES[source]
    for kind in (euler.BC_PERIODIC, euler.BC_SLIP):
        bcs, jbcs = sides(kind)
        ref = jax.jit(jspatial.make_rhs(jbasis, jmesh, jbcs, flux="hllc",
                                        source=jsrc, dtype=jnp.float64))(
            jnp.asarray(u.numpy()), T)
        for form in ("xla", "fused"):
            rhs = make_rhs(basis, mesh, bcs, flux="hllc", dtype=F64,
                           device="cpu", volume_kernel=form, source=src)
            assert rel(ref, rhs(u, T)) <= TOL, (kind, form)
        # the fused form applies its source arm in its stage form too
        sc = torch.tensor([0.75, 1e-3], dtype=F64)
        stage = rhs.stage(u, u.flip(-1), torch.tensor(T, dtype=F64), 0.75,
                          sc[1])
        want = 0.75 * u.flip(-1) + 0.25 * (u + 1e-3 * torch.from_numpy(
            np.array(ref)))
        assert rel(want, stage) <= TOL, kind


def hydrostatic(p, family="Qk_gll", perturb=0.0, nu=None):
    """(basis, mesh, jax mesh, state) of the isothermal (nu None) or
    polytropic hydrostatic state on the unit square at 16 x 16; perturb: a
    seeded multiplicative perturbation of that size."""
    basis = make_basis(family, p)
    mesh, jmesh = CartesianMesh(16, 16, 0.0, 1.0, 0.0, 1.0), \
        JMesh(16, 16, 0.0, 1.0, 0.0, 1.0)
    fn = (jic.isothermal_hydrostatic() if nu is None
          else jic.polytropic_hydrostatic(nu))
    u = np.asarray(jic.set_initial_condition(jax_make_basis(family, p),
                                             jmesh, fn))
    rng = np.random.default_rng(p)
    u = u * (1.0 + perturb * rng.uniform(-1.0, 1.0, u.shape))
    return basis, mesh, jmesh, torch.from_numpy(u)


def phi_torch(x, y):
    return x + y


def phi_jax(x, y):
    return x + y


@pytest.mark.parametrize("wb", ("isothermal", "polytropic"))
def test_well_balanced_residual_matches_jax(wb):
    nu = None if wb == "isothermal" else 1.2
    basis, mesh, jmesh, u = hydrostatic(2, perturb=0.02, nu=nu)
    bcs, jbcs = sides(euler.BC_OUTFLOW)
    pot, jpot = ((phi_torch, phi_jax) if nu is None
                 else (lambda x, y: y, lambda x, y: y))
    ref = jax.jit(jspatial.make_rhs(jax_make_basis("Qk_gll", 2), jmesh, jbcs,
                                    flux="hllc", dtype=jnp.float64,
                                    well_balanced=wb, potential=jpot))(
        jnp.asarray(u.numpy()), T)
    forms = ("xla", "fused") if wb == "isothermal" else ("xla",)
    for form in forms:
        rhs = make_rhs(basis, mesh, bcs, flux="hllc", dtype=F64,
                       device="cpu", volume_kernel=form, well_balanced=wb,
                       potential=pot)
        assert rel(ref, rhs(u, T)) <= TOL, form


def run_steps(s, u, n):
    t = 0.0
    for _ in range(n):
        u, dt, bad, _ = s._step(u, t, 1e9)
        assert not bool(bad)
        t += float(dt)
    return u


@pytest.mark.parametrize("case", ("isothermal-1", "isothermal-2",
                                  "polytropic-2"))
def test_hydrostatic_state_is_well_balanced(case):
    wb, p = case.split("-")
    nu = None if wb == "isothermal" else 1.2
    basis, mesh, _, u0 = hydrostatic(int(p), nu=nu)
    bcs, _ = sides(euler.BC_OUTFLOW)
    s = Solver(basis, mesh, bcs, flux="lxf", cfl=0.5, dtype=F64,
               device="cpu", well_balanced=wb,
               potential=phi_torch if nu is None else (lambda x, y: y))
    # isothermal rides the fused residual (its plain version here),
    # polytropic the plain residual, as in the reference
    assert s.volume_kernel == ("fused" if nu is None else "xla")
    drift = float((run_steps(s, u0, 25) - u0).abs().max())
    assert drift < DRIFT, drift


def test_naive_source_is_not_well_balanced():
    """tests/test_gravity.py:54: the pointwise force -rho grad(phi) does
    real work only through the well-balanced form."""
    basis, mesh, _, u0 = hydrostatic(1)
    bcs, _ = sides(euler.BC_OUTFLOW)
    naive = euler.ExternalForce(lambda x, y, t: (torch.full_like(x, -1.21),
                                                 torch.full_like(x, -1.21)))
    s = Solver(basis, mesh, bcs, flux="lxf", cfl=0.5, dtype=F64,
               device="cpu", source=naive)
    drift = float((run_steps(s, u0, 25) - u0).abs().max())
    assert drift > 1e-8, drift


def rt_ic(x, y, t=0.0):
    """tests/test_pallas.py:388's heavy-over-light state."""
    m = jnp if isinstance(x, jnp.ndarray) else torch
    rho = m.where(y > 0.0, 2.0, 1.0)
    p = 2.5 - 0.1 * rho * y
    vy = 0.01 * (1.0 + m.cos(4.0 * np.pi * x)) \
        * (1.0 + m.cos(3.0 * np.pi * y)) / 4.0
    return m.stack([0.0 * x, rho * vy, rho,
                    p / (euler.GAMMA - 1.0) + 0.5 * rho * vy ** 2])


def steps_against_jax(family, p, lim, fn, cellwise=False, n=3):
    """n Solver steps of the port (auto forms: the kernels' plain versions
    here) and of dflo_tpu (XLA) from the same post-staged IC, gravity
    (0, -0.1), periodic x, slip y, 16 x 48 on the RT box; returns the
    largest relative difference over the steps, and the port's solver."""
    mesh = CartesianMesh(16, 48, -0.25, 0.25, -0.75, 0.75)
    jmesh = JMesh(16, 48, -0.25, 0.25, -0.75, 0.75)
    per, jper = sides(euler.BC_PERIODIC)
    slip, jslip = sides(euler.BC_SLIP)
    bcs = dict(W=per["W"], E=per["E"], S=slip["S"], N=slip["N"])
    jbcs = dict(W=jper["W"], E=jper["E"], S=jslip["S"], N=jslip["N"])
    jbasis = jax_make_basis(family, p)
    js = JSolver(jbasis, jmesh, jbcs, flux="hllc",
                 limiter=JLimiterConfig(**lim), cfl=0.4, source=jax_grav)
    s = Solver(make_basis(family, p), mesh, bcs, flux="hllc",
               limiter=LimiterConfig(**lim), cfl=0.4, dtype=F64,
               device="cpu", source=euler.GravitySource(0.0, -0.1))
    set_ic = (jic.set_initial_condition_cellcentered if cellwise
              else jic.set_initial_condition)
    uj = jax.jit(js.post_stage)(set_ic(jbasis, jmesh, fn))
    u = s.post_stage(torch.from_numpy(np.asarray(uj)))
    assert rel(uj, u) <= TOL
    err, t = 0.0, 0.0
    for _ in range(n):
        uj, dtj, _, _ = js._step(uj, t, 1.0)
        u, dt, bad, _ = s._step(u, t, 1.0)
        assert not bool(bad)
        assert abs(float(dt) - float(dtj)) <= 1e-14 * float(dtj)
        t += float(dtj)
        err = max(err, rel(uj, u))
    return err, s


def test_rayleigh_taylor_steps_match_jax():
    """tests/test_pallas.py:368 at 16 x 48: the gravity source through the
    fused residual and the fused TVB post (their plain versions here)."""
    lim = dict(type="TVB", shock_indicator="limiter", beta=1.0,
               char_lim=False, pos_lim=True)
    err, s = steps_against_jax("Qk", 2, lim, rt_ic)
    assert (s.volume_kernel, s.post_kernel) == ("fused", "fused")
    assert s.rhs.ops.source == "grav"
    assert err <= 1e-11, err


def test_gll_tvb_steps_match_jax():
    """GLL under TVB (the nodal limiter on the Gauss-Lobatto nodes, the
    plain post chain: the fused post is Gauss-Qk-only) with the cell-wise
    rt_gll IC and gravity."""
    lim = dict(type="TVB", shock_indicator="density", beta=2.0,
               char_lim=True, pos_lim=True)
    err, s = steps_against_jax("Qk_gll", 2, lim, jic.rayleigh_taylor_gll(1.0),
                               cellwise=True)
    assert (s.volume_kernel, s.post_kernel) == ("fused", "xla")
    assert err <= 1e-11, err


def test_source_forms_resolve_and_refuse():
    basis, mesh, _, _ = hydrostatic(2)
    bcs, _ = sides(euler.BC_OUTFLOW)
    generic = SOURCES["gravity"][1]          # a plain callable
    lim = LimiterConfig()
    grav = euler.GravitySource(0.0, -1.0)
    forms = {
        "grav": _kernel_forms(basis, "hllc", "rk", lim, "auto", "auto", grav),
        "generic": _kernel_forms(basis, "hllc", "rk", lim, "auto", "auto",
                                 generic),
        "iso": _kernel_forms(basis, "hllc", "rk", lim, "auto", "auto", None,
                             "isothermal"),
        "poly": _kernel_forms(basis, "hllc", "rk", lim, "auto", "auto", None,
                              "polytropic"),
    }
    assert forms == {"grav": ("fused", "xla"), "generic": ("xla", "xla"),
                     "iso": ("fused", "xla"), "poly": ("xla", "xla")}
    kw = dict(dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_rhs(basis, mesh, bcs, source=grav, well_balanced="isothermal",
                 potential=phi_torch, **kw)
    with pytest.raises(ValueError, match="polytropic"):
        make_rhs(basis, mesh, bcs, volume_kernel="fused",
                 well_balanced="polytropic", potential=phi_torch, **kw)
    with pytest.raises(NotImplementedError, match="GravitySource"):
        make_rhs(basis, mesh, bcs, volume_kernel="fused", source=generic,
                 **kw)
    with pytest.raises(ValueError, match="collocated"):
        make_rhs(make_basis("Pk", 2), mesh, bcs, well_balanced="isothermal",
                 potential=phi_torch, **kw)
    with pytest.raises(ValueError, match="potential"):
        make_rhs(basis, mesh, bcs, well_balanced="isothermal", **kw)
    # MOOD with a GravitySource runs (tests/test_torch_mood.py); with a
    # source callable the kernel's source arm does not carry, on the plain
    # residual (tests/test_torch_mood_routes.py)
    lim_mood = LimiterConfig(type="TVB", pos_lim=True)
    sm = Solver(make_basis("Pk", 2), mesh, bcs, limiter=lim_mood,
                method="mood", source=generic, **kw)
    assert sm.volume_kernel == "xla" and sm._pk_post_ops is None
    dm = device_mesh((2, 2), [torch.device("cpu")] * 4)
    with pytest.raises(NotImplementedError, match="slice G, the rest of multi-GPU"):
        Solver(make_basis("Qk", 2), mesh, bcs,
               limiter=LimiterConfig(type="TVB"), source=grav,
               device_mesh=dm, **kw)
    with pytest.raises(NotImplementedError, match="slice G, the rest of multi-GPU"):
        make_rhs(make_basis("Qk", 2), mesh, bcs, volume_kernel="fused",
                 source=grav, device_mesh=dm, **kw)


def test_source_launch_keys():
    """The launch-count keys of the source forms (chip_smoke's phase 18
    reads them): basis qk, gll or pk, then flux, source and form."""
    bcs, _ = sides(euler.BC_OUTFLOW)
    mesh = CartesianMesh(8, 8, 0.0, 1.0, 0.0, 1.0)
    grav = kernels.residual_operators(make_basis("Qk", 1), mesh, flux="hllc",
                                      source=euler.GravitySource(0.0, -1.0),
                                      dtype=F64, device="cpu")
    iso = kernels.residual_operators(make_basis("Qk_gll", 2), mesh,
                                     well_balanced="isothermal",
                                     potential=phi_torch, dtype=F64,
                                     device="cpu")
    sc = torch.zeros(2, dtype=F64)
    assert kernels._residual_form(grav, u_old=sc) == \
        "fused_residual[qk_hllc_grav_stage]"
    assert kernels._residual_form(iso, u_old=sc) == \
        "fused_residual[gll_lxf_wbiso_stage]"
    assert kernels._residual_form(iso, dt=sc) == \
        "fused_residual[gll_lxf_wbiso_step]"
    # the isothermal arm's operators: the nodal derivatives, 1/dx, 1/dy and
    # the potential at the nodes
    assert iso.phi.shape == (9, 8, 8) and iso.inv_d.tolist() == [8.0, 8.0]
    assert torch.equal(iso.Gxn, torch.as_tensor(make_basis("Qk_gll", 2).Gx))


def test_cli_external_force_matches_jax(tmp_path):
    """The CLI's f_0/f_1 force builds an euler.ExternalForce (the JAX
    CLI's _build_source, dflo_tpu/cli.py:130-147) whose fused residual (its
    plain version here) at t = 0.37 matches dflo_tpu's residual with the
    JAX CLI's source."""
    from dflo_tpu import cli as jcli
    from dflo_tpu.config.params import AllParameters as JParams
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    src = open("examples/rayleigh_taylor.prm").read()
    src = src.replace("set gravity = 1.0", "set f_0 value = "
                      "0.01*sin(2*pi*x)*cos(t)\nset f_1 value = -1.0")
    src = src.replace("set nx = 50", "set nx = 16").replace("set ny = 150",
                                                            "set ny = 48")
    prm = tmp_path / "rt_force.prm"
    prm.write_text(src)
    params = AllParameters.from_prm_file(str(prm))
    s, _ = cli.build_solver(params, dtype=F64, device="cpu")
    assert s.rhs.ops.source == "force" and s.volume_kernel == "fused"
    u = cli.set_ic(params, s)
    _, jslip = sides(euler.BC_SLIP)
    ref = jax.jit(jspatial.make_rhs(
        jax_make_basis("Qk", 1), JMesh(16, 48, -0.25, 0.25, -0.75, 0.75),
        jslip, flux="hllc", dtype=jnp.float64,
        source=jcli._build_source(JParams.from_prm_file(str(prm)))))(
        jnp.asarray(u.numpy()), T)
    assert rel(ref, s.rhs(u, T)) <= TOL
