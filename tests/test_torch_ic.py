"""The port's initial conditions against the JAX package's, in float64 on
the CPU.

Every named analytic state of dflo_tpu.ic is evaluated by both packages on
the same points (made from a seeded numpy generator, in the regions each
IC is meant for, with a time for the time-dependent one), and the
cell-centred setters through set_initial_condition_cellcentered on a Q2
mesh: 1e-14 relative to the largest magnitude per component (the same
expressions; elementary functions may round the last bit differently).
The IC tables carry the same names and build the same states; the setter
(Qk interpolation, Pk projection) of the isentropic vortex and l2_error of
a perturbed state against it agree to 1e-14 as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import ic as jic
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu_torch import ic
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis

TOL = 1e-14
F64 = torch.float64


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a| (a zero component must
    agree exactly)."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


def points(lo: float, hi: float, n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)


#: name -> (port builder, reference builder, coordinate range, time)
ANALYTIC = {
    "isentropic_vortex": (lambda: ic.isentropic_vortex(5.0, 0.3, -0.2),
                          lambda: jic.isentropic_vortex(5.0, 0.3, -0.2),
                          (-5.0, 5.0), 0.0),
    "isentropic_vortex_steady": (ic.isentropic_vortex_steady,
                                 jic.isentropic_vortex_steady, (-5.0, 5.0),
                                 0.0),
    "vortex_system": (ic.vortex_system, jic.vortex_system, (-20.0, 20.0),
                      0.0),
    "rayleigh_taylor": (lambda: ic.rayleigh_taylor(0.5),
                        lambda: jic.rayleigh_taylor(0.5), (-0.75, 0.75),
                        0.0),
    "polytropic_hydrostatic": (ic.polytropic_hydrostatic,
                               jic.polytropic_hydrostatic, (0.0, 1.0), 0.0),
    "isothermal_hydrostatic": (lambda: ic.isothermal_hydrostatic(0.1),
                               lambda: jic.isothermal_hydrostatic(0.1),
                               (0.0, 1.0), 0.0),
    "radial_rayleigh_taylor": (ic.radial_rayleigh_taylor,
                               jic.radial_rayleigh_taylor, (-1.0, 1.0), 0.0),
    "unsteady_gravity": (ic.unsteady_gravity, jic.unsteady_gravity,
                         (0.0, 2.0), 0.37),
    "keplerian_disk": (ic.keplerian_disk, jic.keplerian_disk, (0.1, 3.0),
                       0.0),
}


@pytest.mark.parametrize("name", sorted(ANALYTIC))
def test_analytic_ic_matches_jax(name):
    port, ref, (lo, hi), t = ANALYTIC[name]
    x, y = points(lo, hi, seed=len(name))
    if name == "vortex_system":           # and the pressure patch
        x[:20], y[:20] = x[:20] * 0.004, y[:20] * 0.004
    want = np.asarray(ref()(jnp.asarray(x), jnp.asarray(y), t))
    got = port()(torch.from_numpy(x), torch.from_numpy(y), t)
    assert got.dtype == F64 and got.shape == (4, x.size)
    assert np.isfinite(want).all()
    assert rel(want, got) <= TOL
    # the caller's dtype is kept
    assert port()(torch.from_numpy(x).float(), torch.from_numpy(y).float(),
                  t).dtype == torch.float32


def test_ic_tables_match_jax():
    assert sorted(ic.IC_FUNCTIONS) == sorted(jic.IC_FUNCTIONS)
    assert sorted(ic.IC_CELLWISE) == sorted(jic.IC_CELLWISE)
    x, y = points(-1.5, 1.5, seed=3)
    y = np.abs(y) + 0.05                  # inside the polytropic column

    class Params:
        gravity = 0.7

    for name in sorted(ic.IC_FUNCTIONS):
        want = np.asarray(jic.IC_FUNCTIONS[name](Params())(
            jnp.asarray(x), jnp.asarray(y)))
        got = ic.IC_FUNCTIONS[name](Params())(torch.from_numpy(x),
                                              torch.from_numpy(y))
        assert rel(want, got) <= TOL, name


@pytest.mark.parametrize("name", ("shocktube", "rt_gll"))
def test_cellcentered_setter_matches_jax(name):
    """set_initial_condition_cellcentered of the src_gll setters on Q2
    (the jump placed by the cell centre, the rest pointwise)."""
    basis, jbasis = make_basis("Qk", 2), jax_make_basis("Qk", 2)
    lo, hi = (0.0, 1.0) if name == "shocktube" else (-0.5, 0.5)
    mesh = CartesianMesh(20, 6, lo, hi, lo, hi)
    jmesh = JMesh(20, 6, lo, hi, lo, hi)

    class Params:
        gravity = 1.3

    want = np.asarray(jic.set_initial_condition_cellcentered(
        jbasis, jmesh, jic.IC_CELLWISE[name](Params()), dtype=jnp.float64))
    got = ic.set_initial_condition_cellcentered(
        basis, mesh, ic.IC_CELLWISE[name](Params()), dtype=F64,
        device="cpu")
    assert got.shape == (4, 9, 6, 20) and got.is_contiguous()
    assert rel(want, got) <= TOL
    if name == "shocktube":
        # every node of a cell takes its cell centre's side of the jump
        rho = got[2].numpy()
        assert np.all(rho.min(0) == rho.max(0))


@pytest.mark.parametrize("family, p", (("Qk", 2), ("Pk", 2), ("Pk", 1)))
def test_setter_and_l2_error_match_jax(family, p):
    """set_initial_condition of the named vortex on Qk / Pk, then l2_error
    of a perturbed state against the vortex, both against dflo_tpu's."""
    mesh = CartesianMesh(12, 10, -5.0, 5.0, -5.0, 5.0)
    basis, jbasis = make_basis(family, p), jax_make_basis(family, p)
    fn, jfn = ic.IC_FUNCTIONS["isenvort"](), jic.IC_FUNCTIONS["isenvort"]()
    want = np.asarray(jic.set_initial_condition(jbasis, mesh, jfn,
                                                dtype=jnp.float64))
    got = ic.set_initial_condition(basis, mesh, fn, dtype=F64, device="cpu")
    assert rel(want, got) <= TOL
    rng = np.random.default_rng(p)
    u = want * (1.0 + 1e-3 * rng.standard_normal(want.shape))
    e_ref = np.asarray(jic.l2_error(jbasis, mesh, jnp.asarray(u), jfn))
    e = ic.l2_error(basis, mesh, torch.from_numpy(u), fn)
    assert e.shape == (4,) and e.dtype == F64
    assert np.abs(e_ref - e.numpy()).max() <= TOL * np.abs(e_ref).max()
    assert float(ic.l2_error(basis, mesh, got, fn, nq=p + 3)[2]) < 0.05
