"""The Roe, Steger-Warming, KFVS and KEP fluxes of the port against the JAX
package's, in float64 on the CPU, and the residual forms built on them.

Fluxes: steger_warming, roe, kfvs, kfvs_kernel (the A&S erf) and kep, and
logavg, on random states made with a numpy seed (states near the logavg
series switch u = f^2 = 1e-2 and near vacuum among them), against
dflo_tpu.physics.fluxes to 1e-12 relative to each component's largest
magnitude; their torch.func.jvp against jax.jvp to 1e-11.

Residuals, at 16 x 8 on the unit square (farfield W/E, slip S/N, the
Gaussian bump of tests/test_implicit.py:83-110 with a seeded 2 %
perturbation): for each new flux on Q1, GLL2, P2 and Q1 with a solid
block, the port's plain residual (make_rhs "xla") against dflo_tpu's, and
the kernel's plain twin (fused_residual_plain with its strips) in its R,
u + dt*R and SSP-stage forms against dflo_tpu's residual: make_rhs "xla"
for roe, sw and kep (equal to the kernel's function up to round-off) and
the fused residual (the Pallas kernel in interpret mode) for kfvs, whose
kernel form takes the A&S erf.  1e-12 relative to max|R| per component.

MOOD with each new flux (the candidate kernel's plain twin on the sparse
route): a stage of the port's cascade on P2 (the stage predictor's
candidates with the flux, the check, the degree and mark bookkeeping)
against dflo_tpu's jitted mood_stage on the same predictor, at 32 x 8,
from a contact discontinuity in the Mach-10 DMR flow and from the port's
states after one and two steps (the cascade fires, no cell near the
pressure floor): the candidate within 1e-10 relative, equal limiter marks
and MoodStats.  dflo_tpu runs its XLA path for roe, sw and kep and its fused
path (the Pallas kernels in interpret mode) for kfvs, whose kernel form
takes the A&S erf, as the port's.  And the port's sparse cascade equals
its dense one (sparse_mode="off") bitwise, with equal MoodStats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.physics import fluxes as jfluxes
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import entry, ic
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.physics import fluxes
from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs

F64 = torch.float64
NEW = ("roe", "sw", "kfvs", "kep")
NX, NY = 16, 8
FAR = (0.5, 0.0, 1.0, 2.6)


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


def states(rng, n, rho=(0.2, 3.0), p=(0.1, 3.0)):
    """n conserved states [4, n] from uniform primitive values."""
    r = rng.uniform(*rho, n)
    u, v = rng.uniform(-2.0, 2.0, n), rng.uniform(-2.0, 2.0, n)
    pr = rng.uniform(*p, n)
    return np.stack([r * u, r * v, r, pr / 0.4 + 0.5 * r * (u * u + v * v)])


@pytest.fixture(scope="module")
def flux_inputs():
    """(UL, UR, AL, AR) [4, n]: generic states, right states within 1e-3
    of the left ones (logavg's series branch), pairs straddling the series
    switch, and near-vacuum states."""
    rng = np.random.default_rng(8)
    UL, UR, AL, AR = (states(rng, 400) for _ in range(4))
    UR[:, :100] = UL[:, :100] * (1.0 + 1e-3 * rng.standard_normal((4, 100)))
    # density ratios xi with f = (xi - 1)/(xi + 1) near 0.1 (u = 0.01)
    xi = (1.1 / 0.9) * (1.0 + 1e-6 * rng.standard_normal(50))
    UR[:, 100:150] = UL[:, 100:150] * xi
    AR[:, 100:150] = AL[:, 100:150] * xi
    vac = states(rng, 50, rho=(1e-9, 1e-8), p=(1e-9, 1e-8))
    UL[:, 150:200], AL[:, 150:200] = vac, vac
    return UL, UR, AL, AR


@pytest.mark.parametrize("normal", ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0)))
@pytest.mark.parametrize("name", NEW + ("kfvs_kernel",))
def test_flux_matches_jax(flux_inputs, name, normal):
    UL, UR, AL, AR = flux_inputs
    if name == "kfvs_kernel":
        fj, ft = jfluxes.kfvs_kernel, fluxes.kfvs_kernel
    else:
        fj, ft = jfluxes.get_flux(name), fluxes.get_flux(name)
    ref = fj(*(jnp.asarray(a) for a in (UL, UR)), *normal,
             AL=jnp.asarray(AL), AR=jnp.asarray(AR))
    out = ft(*(torch.from_numpy(a) for a in (UL, UR)), *normal,
             AL=torch.from_numpy(AL), AR=torch.from_numpy(AR))
    assert np.isfinite(out.numpy()).all()
    assert rel(ref, out.numpy()) <= 1e-12


def test_logavg_and_erf_match_jax(flux_inputs):
    UL, UR, _, _ = flux_inputs
    a, b = UL[2], UR[2]
    assert rel(jfluxes.logavg(jnp.asarray(a), jnp.asarray(b))[None],
               fluxes.logavg(torch.from_numpy(a),
                             torch.from_numpy(b)).numpy()[None]) <= 1e-12
    x = np.linspace(-4.0, 4.0, 801)
    assert rel(jfluxes.erf_approx(jnp.asarray(x))[None],
               fluxes.erf_approx(torch.from_numpy(x)).numpy()[None]) <= 1e-12
    # the A&S erf is the kernel's: within 1.5e-7 of the true erf
    assert float((fluxes.erf_approx(torch.from_numpy(x))
                  - torch.special.erf(torch.from_numpy(x))).abs().max()) \
        <= 1.5e-7


def test_get_flux_names():
    assert set(fluxes.FLUX_FUNCTIONS) == set(jfluxes.FLUX_FUNCTIONS)
    assert fluxes.get_flux("kfvs") is fluxes.kfvs
    assert fluxes.get_flux("kfvs", kernel_safe=True) is fluxes.kfvs_kernel
    assert fluxes.get_flux("roe", kernel_safe=True) is fluxes.roe
    with pytest.raises(ValueError, match="unknown numerical flux"):
        fluxes.get_flux("ausm")


@pytest.mark.parametrize("name", NEW)
def test_flux_jvp_matches_jax(flux_inputs, name):
    """Tangents through the double-where guards (_pos, logavg's f_safe)
    stay finite and equal jax.jvp's, the near-vacuum states left out (their
    tangents scale as 1/rho)."""
    UL, UR, AL, AR = (a[:, :150] for a in flux_inputs)
    rng = np.random.default_rng(9)
    tL, tR = rng.standard_normal(UL.shape), rng.standard_normal(UR.shape)
    fj, ft = jfluxes.get_flux(name), fluxes.get_flux(name)
    _, ref = jax.jvp(lambda a, b: fj(a, b, 1.0, 0.0, AL=jnp.asarray(AL),
                                      AR=jnp.asarray(AR)),
                     (jnp.asarray(UL), jnp.asarray(UR)),
                     (jnp.asarray(tL), jnp.asarray(tR)))
    _, out = torch.func.jvp(
        lambda a, b: ft(a, b, 1.0, 0.0, AL=torch.from_numpy(AL),
                        AR=torch.from_numpy(AR)),
        (torch.from_numpy(UL), torch.from_numpy(UR)),
        (torch.from_numpy(tL), torch.from_numpy(tR)))
    assert np.isfinite(out.numpy()).all()
    assert rel(ref, out.numpy()) <= 1e-11


# ---------------------------------------------------------------------------
# the residual forms
# ---------------------------------------------------------------------------

def jax_bcs():
    far = lambda x, y, t: jnp.stack(  # noqa: E731
        [jnp.full_like(x, v) for v in FAR])
    return dict(W=jspatial.BoundarySide(jeuler.BC_FARFIELD, far),
                E=jspatial.BoundarySide(jeuler.BC_FARFIELD, far),
                S=jspatial.BoundarySide(jeuler.BC_SLIP),
                N=jspatial.BoundarySide(jeuler.BC_SLIP))


def torch_bcs():
    def far(x, y, t):
        return torch.stack([torch.full_like(x, v) for v in FAR])
    return dict(W=BoundarySide(euler.BC_FARFIELD, far),
                E=BoundarySide(euler.BC_FARFIELD, far),
                S=BoundarySide(euler.BC_SLIP), N=BoundarySide(euler.BC_SLIP))


#: case -> (basis family, degree, masked)
CASES = {"q1": ("Qk", 1, False), "gll2": ("Qk_gll", 2, False),
         "p2": ("Pk", 2, False), "q1_masked": ("Qk", 1, True)}


def block_mask():
    """A solid 3 x 2 block of cells off the centre."""
    m = np.ones((NY, NX), bool)
    m[3:5, 9:12] = False
    return m


def bump_state(family, p, masked, seed):
    """The bump on the basis (the port's IC setter) with a 2 % seeded
    perturbation; solid cells pinned to (0, 0, 1, 2.5)."""
    basis = make_basis(family, p)
    mesh = CartesianMesh(NX, NY, 0.0, 1.0, 0.0, 1.0)

    def fn(x, y, t=0.0):
        b = 0.05 * torch.exp(-50.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
        return torch.stack([0.5 + b, b, 1.0 + b, torch.full_like(x, 2.6)])

    u = ic.set_initial_condition(basis, mesh, fn, dtype=F64,
                                 device="cpu").numpy()
    rng = np.random.default_rng(seed)
    u = u * (1.0 + 0.02 * rng.uniform(-1.0, 1.0, u.shape))
    if masked:
        u = np.where(block_mask(), u,
                     np.array([0.0, 0.0, 1.0, 2.5])[:, None, None, None])
    return basis, mesh, u


@pytest.fixture(scope="module")
def jax_residuals():
    """(case, flux) -> (state, dflo_tpu's R of the kernel's function, its
    R of make_rhs "xla"), each JAX residual built once."""
    out = {}
    for ci, (case, (family, p, masked)) in enumerate(sorted(CASES.items())):
        jb = jax_make_basis(family, p)
        jm = JMesh(NX, NY, 0.0, 1.0, 0.0, 1.0)
        mask = block_mask() if masked else None
        for flux in NEW:
            _, _, u = bump_state(family, p, masked, seed=10 + ci)
            xla = jspatial.make_rhs(jb, jm, jax_bcs(), flux=flux, mask=mask,
                                    dtype=jnp.float64, volume_kernel="xla")
            r_xla = np.asarray(xla(jnp.asarray(u), 0.25))
            r_kernel = r_xla
            if flux == "kfvs":
                fused = jspatial.make_rhs(jb, jm, jax_bcs(), flux=flux,
                                          mask=mask, dtype=jnp.float64,
                                          volume_kernel="fused")
                r_kernel = np.asarray(fused(jnp.asarray(u), 0.25))
            out[case, flux] = (u, r_kernel, r_xla)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("flux", NEW)
def test_residual_forms_match_jax(jax_residuals, flux, case):
    family, p, masked = CASES[case]
    u_np, r_kernel, r_xla = jax_residuals[case, flux]
    basis = make_basis(family, p)
    mesh = CartesianMesh(NX, NY, 0.0, 1.0, 0.0, 1.0)
    mask = block_mask() if masked else None
    u = torch.from_numpy(u_np)
    t = 0.25
    plain = make_rhs(basis, mesh, torch_bcs(), flux=flux, dtype=F64,
                     device="cpu", volume_kernel="xla", mask=mask)
    assert rel(r_xla, plain(u, t).numpy()) <= 1e-12
    fused = make_rhs(basis, mesh, torch_bcs(), flux=flux, dtype=F64,
                     device="cpu", volume_kernel="fused", mask=mask)
    strips = fused.strips(u, t)
    R = kernels.fused_residual(u, *strips, fused.ops)
    assert rel(r_kernel, R.numpy()) <= 1e-12
    # the other two forms against the same residual, blended in numpy
    h, a = 1e-3, 0.75
    u_old = np.flip(u_np, -1).copy()
    step = kernels.fused_residual(u, *strips, fused.ops,
                                  dt=torch.tensor(h, dtype=F64))
    assert rel(u_np + h * r_kernel, step.numpy()) <= 1e-12
    stage = kernels.fused_residual(u, *strips, fused.ops,
                                   u_old=torch.from_numpy(u_old),
                                   sc=torch.tensor([a, h], dtype=F64))
    assert rel(a * u_old + (1.0 - a) * (u_np + h * r_kernel),
               stage.numpy()) <= 1e-12
    if masked:
        assert float(R[..., ~torch.from_numpy(block_mask())].abs().max()) \
            == 0.0


def test_new_fluxes_refuse_mood_and_source_arms():
    """The source arms take the four new fluxes too, as the reference's do
    (its arms call get_flux(flux_name, kernel_safe=True),
    pallas_kernels.py:273): a MOOD Solver with roe and gravity builds on
    the residual's gravity arm (the dense route, no sparse candidate), and
    kep with gravity on Q1 resolves "auto" to the fused residual's gravity
    arm, on every device; "xla" stays the plain residual.  The tests of
    tests/test_torch_envelope.py hold these arms against dflo_tpu."""
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    basis = make_basis("Pk", 2)
    mesh = CartesianMesh(NX, NY, 0.0, 1.0, 0.0, 1.0)
    lim = LimiterConfig(type="TVB", pos_lim=True)
    s = Solver(basis, mesh, torch_bcs(), flux="roe", limiter=lim,
               method="mood", dtype=F64, device="cpu")
    assert s._mood_stage.sparse and s.rhs.ops.flux == "roe"
    s = Solver(basis, mesh, torch_bcs(), flux="roe", limiter=lim,
               method="mood", source=euler.GravitySource(0.0, -1.0),
               dtype=F64, device="cpu")
    assert not s._mood_stage.sparse
    assert (s.rhs.ops.flux, s.rhs.ops.source) == ("roe", "grav")
    for vk in ("auto", "xla", "fused"):
        s = Solver(make_basis("Qk", 1), mesh, torch_bcs(), flux="kep",
                   source=euler.GravitySource(0.0, -1.0), dtype=F64,
                   device="cpu", volume_kernel=vk)
        assert s.volume_kernel == ("xla" if vk == "xla" else "fused")
        if vk != "xla":
            assert (s.rhs.ops.flux, s.rhs.ops.source) == ("kep", "grav")


# ---------------------------------------------------------------------------
# MOOD with the new fluxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flux", NEW)
def test_mood_with_new_fluxes_matches_jax(flux):
    import __graft_entry__ as graft
    from dflo_tpu.driver import LimiterConfig as JLim
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu_torch import interop
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    from dflo_tpu_torch.stab.mood import make_mood
    nx, ny = 32, 8
    lim = dict(type="TVB", shock_indicator="density", beta=2.0,
               char_lim=True, pos_lim=True)
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    js = JSolver(jax_make_basis("Pk", 2), mesh,
                 graft._build(nx, ny, method="mood")[0].bcs, flux=flux,
                 limiter=JLim(**lim), cfl=0.5, dtype=jnp.float64,
                 method="mood",
                 volume_kernel="fused" if flux == "kfvs" else "xla",
                 post_kernel="xla")
    ts = Solver(make_basis("Pk", 2), mesh,
                entry._build(nx, ny, device="cpu", method="mood")[0].bcs,
                flux=flux, limiter=LimiterConfig(**lim), cfl=0.5,
                dtype=F64, device="cpu", method="mood")
    assert ts.rhs.ops.flux == flux and ts._mood_stage.sparse
    u = ts.post_stage(ic.set_initial_condition(
        ts.basis, mesh, entry.contact_ic, dtype=F64, device="cpu"))
    # the cascade of one stage (candidate with the flux, check, degree and
    # mark bookkeeping) from the contact and from the port's states after
    # one and two steps, each at the step's own t and dt
    stage = jax.jit(js._mood_stage)
    v, t, fired = u, 0.0, 0
    for k in range(3):
        dt = float(ts.cfl / ts._diag(v)[0] / 5.0)
        ref = stage(jnp.asarray(v.numpy()), jnp.asarray(t), jnp.asarray(dt))
        got = ts._mood_stage(v, torch.tensor(t, dtype=F64),
                             torch.tensor(dt, dtype=F64))
        assert rel(np.asarray(ref[0]), got[0].numpy()) <= 1e-10, k
        assert np.array_equal(np.asarray(ref[1]), got[1].numpy()), k
        assert np.array_equal(interop.stats_as_numpy(ref[2]),
                              interop.stats_as_numpy(got[2])), k
        fired += int(got[2].n_reduce)
        v, dtt, bad, _ = ts._step(v, t, 1.0)
        t += float(dtt)
        assert not bool(bad)
    assert fired > 0
    # sparse against dense, one step from the same state
    dense = make_mood(ts.basis, mesh, ts.rhs, sparse_mode="off")
    assert not dense.sparse
    a = ts._mood_stage(u, torch.tensor(0.0, dtype=F64),
                       torch.tensor(1e-3, dtype=F64))
    b = dense(u, torch.tensor(0.0, dtype=F64), torch.tensor(1e-3, dtype=F64))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[3], b[3]) and a[2].iters == b[2].iters
    assert int(a[2].n_reduce) == int(b[2].n_reduce) > 0
