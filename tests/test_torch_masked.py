"""The port's masked forward-step pieces against the JAX package's, on the
CPU, in float64 unless a test says otherwise.

The configuration is examples/forward_step_tpu.prm cut to 60 x 20 cells (the
3 x 1 box with the solid step (x>0.6)*(y<0.2), Q_p, LxF, inflow W, outflow
E, slip S and N), set up by each package's own config layer and CLI domain
builders.  The state is the inflow state plus a y-momentum, with a 5 %
multiplicative perturbation (numpy rng), solid cells pinned to the benign
state, so every face carries a jump and the slip-wall mirrors at the step's
faces are live.

Tolerances (relative to the reference's largest magnitude per component):
1e-12 for the residual in all three of the port's forms (plain "xla",
"pallas" with the volume term through volume_residual's plain version, and
the fused kernel's plain version with its delta strips), the post chain
and the diagnostics: the two packages differ by the summation order of
their contractions only.  volume_residual against the JAX package's Pallas
kernel (interpret mode) is held in float32, the only dtype that kernel
traces in (it accumulates in float32, pallas_kernels.py:135, and fails to
store into a float64 output), to 1e-6: float32 round-off of the two
summation orders.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import cli as jcli
from dflo_tpu.config.params import AllParameters as JParams
from dflo_tpu.driver import LimiterConfig as JLimiterConfig
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.ops.pallas_kernels import volume_residual as jax_volume_residual
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.physics import fluxes as jfluxes
from dflo_tpu.solver import rk as jrk
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import positivity as jpos
from dflo_tpu_torch import cli
from dflo_tpu_torch.config.params import AllParameters
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import fluxes
from dflo_tpu_torch.solver import rk
from dflo_tpu_torch.solver.spatial import make_rhs
from dflo_tpu_torch.stab import positivity

F64 = torch.float64
TOL = 1e-12
NX, NY = 60, 20


def rel(ref, x) -> float:
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if ref.ndim == 0:
        return float(abs(ref - x) / max(abs(ref), 1e-300))
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)
    err = np.abs(ref - x).reshape(ref.shape[0], -1).max(1)
    return float((err / np.maximum(scale, 1e-300)).max())


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """Both packages' parameters, domain and boundary sides of the cut
    forward step."""
    src = open("examples/forward_step_tpu.prm").read()
    prm = tmp_path_factory.mktemp("fs") / "fs.prm"
    prm.write_text(src.replace("nx = 1920", f"nx = {NX}")
                   .replace("ny = 640", f"ny = {NY}"))
    jp, tp = JParams.from_prm_file(str(prm)), AllParameters.from_prm_file(
        str(prm))
    jmesh, jmask, jbids = jcli.build_domain(jp)
    tmesh, tmask, tbids = cli.build_domain(tp)
    assert np.array_equal(jmask, tmask) and not jmask.all() and jmask.any()
    return (jp, jmesh, jmask, jcli.build_bcs(jp, jbids), tp, tmesh,
            cli.build_bcs(tp, tbids))


def state(p: int, seed: int, mask) -> np.ndarray:
    K = (p + 1) ** 2
    u = np.zeros((4, K, NY, NX))
    # the inflow state, with a y-momentum so that no component is zero
    u[0], u[1], u[2], u[3] = 4.2, 0.5, 1.4, 8.8
    rng = np.random.default_rng(seed)
    u = u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    solid = np.array([0.0, 0.0, 1.0, 2.5])[:, None, None, None]
    return np.where(mask[None, None], u, solid)


@pytest.fixture(scope="module")
def residuals(config):
    """(p, u, the JAX package's masked LxF residual R(u)) on Q1, the
    config's degree (the port's plain residual is degree-generic; the GPU
    tests hold its kernel at p = 1 and 2)."""
    p = 1
    jp, jmesh, jmask, jbcs = config[:4]
    u = state(p, 10 + p, jmask)
    rhs = jspatial.make_rhs(jax_make_basis("Qk", p), jmesh, jbcs,
                            flux="lxf", mask=jmask, volume_kernel="xla")
    return p, u, np.asarray(jax.jit(rhs)(jnp.asarray(u), 0.0))


@pytest.mark.parametrize("form", ("xla", "pallas", "fused"))
def test_masked_lxf_residual_matches_jax(config, residuals, form):
    p, u, R_ref = residuals
    tp, tmesh, tbcs = config[4:]
    jmask = config[2]
    rhs = make_rhs(make_basis("Qk", p), tmesh, tbcs, flux="lxf", dtype=F64,
                   device="cpu", volume_kernel=form, mask=jmask)
    ut = torch.from_numpy(u)
    assert rel(R_ref, rhs(ut, 0.0)) <= TOL
    # solid cells' residual is zero
    assert float(rhs(ut, 0.0)[..., ~torch.from_numpy(jmask)].abs().max()) == 0
    if form == "fused":
        # the SSP-stage form of the kernel's plain version
        u_old = torch.from_numpy(state(p, 99, jmask))
        dt = torch.tensor(1e-4, dtype=F64)
        stage = rhs.stage(ut, u_old, 0.0, 0.75, dt)
        ref = 0.75 * u_old.numpy() + 0.25 * (u + 1e-4 * R_ref)
        assert rel(ref, stage) <= TOL


@pytest.mark.parametrize("p", (1, 2))
def test_volume_residual_matches_jax(p):
    """volume_residual's plain version against the JAX package's Pallas
    kernel (interpret mode, float32, 1e-6) and against its XLA volume term
    (float64, 1e-12), at 16 x 8 as tests/test_pallas.py does."""
    from dflo_tpu.mesh import CartesianMesh as JMesh
    basis = jax_make_basis("Qk", p)
    mesh = JMesh(16, 8, 0.0, 3.0, 0.0, 1.0)
    lift = np.concatenate([mesh.dy * (basis.wq2[:, None] * basis.Gx).T,
                           mesh.dx * (basis.wq2[:, None] * basis.Gy).T], 1)
    rng = np.random.default_rng(p)
    u = np.zeros((4, basis.K, 8, 16))
    u[0], u[1], u[2], u[3] = 4.2, -0.7, 1.4, 8.8
    u = u * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    R32 = np.asarray(jax_volume_residual(jnp.asarray(lift, jnp.float32),
                                         jnp.asarray(u, jnp.float32)))
    t32 = kernels.volume_residual(torch.tensor(lift, dtype=torch.float32),
                                  torch.tensor(u, dtype=torch.float32))
    assert rel(R32, t32) <= 1e-6
    W = jnp.asarray(u)
    R64 = np.asarray(jspatial.basis_apply(
        jnp.asarray(lift), jnp.concatenate([jeuler.flux_x(W),
                                            jeuler.flux_y(W)], axis=1)))
    assert rel(R64, kernels.volume_residual(torch.tensor(lift),
                                            torch.tensor(u))) <= TOL


def test_lxf_matches_jax():
    rng = np.random.default_rng(3)

    def states(n=64):
        w = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.uniform(0.5, 2.0, n), rng.uniform(5.0, 12.0, n)])
        return w[:, None, :].repeat(2, 1)              # [4, 2, n]

    UL, UR, AL, AR = states(), states(), states(), states()
    for nrm in ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0)):
        ref = jfluxes.lxf(*(jnp.asarray(a) for a in (UL, UR)), *nrm,
                          AL=jnp.asarray(AL), AR=jnp.asarray(AR))
        out = fluxes.lxf(*(torch.from_numpy(a) for a in (UL, UR)), *nrm,
                         AL=torch.from_numpy(AL), AR=torch.from_numpy(AR))
        assert rel(np.asarray(ref), out) <= 1e-13
        # without averages the traces stand in, as in the reference
        ref = jfluxes.lxf(jnp.asarray(UL), jnp.asarray(UR), *nrm)
        out = fluxes.lxf(torch.from_numpy(UL), torch.from_numpy(UR), *nrm)
        assert rel(np.asarray(ref), out) <= 1e-13


def test_masked_limiter_post_and_diag_match_jax(config):
    """The `limiter`-indicator post (every cell to the TVB gate, masked
    neighbor flags, positivity) and its diag against the JAX package's
    Solver.post_stage, compute_dt and negative_average_flag with the same
    mask, on Q1; the port's Solver.post_stage pins the solid cells first."""
    jp, jmesh, jmask, jbcs, tp, tmesh, tbcs = config
    p = 1
    jlim = JLimiterConfig(type="TVB", shock_indicator="limiter", beta=2.0,
                          char_lim=True, pos_lim=True)
    js = JSolver(jax_make_basis("Qk", p), jmesh, jbcs, flux="lxf",
                 limiter=jlim, cfl=0.5, mask=jmask, dtype=jnp.float64)
    lim = LimiterConfig(type="TVB", shock_indicator="limiter", beta=2.0,
                        char_lim=True, pos_lim=True)
    ts = Solver(make_basis("Qk", p), tmesh, tbcs, flux="lxf", limiter=lim,
                cfl=0.5, mask=jmask, dtype=F64, device="cpu")
    u = state(p, 20 + p, jmask)
    u[:, :, ~jmask] *= 1.5               # post_stage pins them again
    ref = np.asarray(jax.jit(js.post_stage)(jnp.asarray(u)))
    ut = torch.from_numpy(u)
    out = ts.post_stage(ut)
    assert rel(ref, out) <= TOL
    # the chain limited cells (marked everywhere, the change gate decides)
    assert not np.allclose(ref, js.apply_mask(jnp.asarray(u)))
    u1, lam, minq = kernels.fused_post_plain(ts.apply_mask(ut), ts._post_ops,
                                             with_diag=True)
    assert torch.equal(u1, out)

    # diagnostics of the limited state (the chain keeps cell means)
    ubar_j = js.cell_averages(jnp.asarray(ref))
    fm = jnp.asarray(jmask)
    dt_ref = float(jrk.compute_dt(ubar_j, jmesh, p, 0.5, mask=fm))
    assert rel(dt_ref, 0.5 / float(lam) / (2 * p + 1)) <= TOL
    ubar = ts.cell_averages(out)
    mask_t = torch.from_numpy(jmask)
    assert rel(dt_ref, rk.compute_dt(ubar, tmesh, p, 0.5, mask=mask_t)) <= TOL
    lam_d, minq_d = kernels.fused_diag_plain(out, ts._diag_ops)
    assert rel(float(lam), lam_d) <= TOL and rel(float(minq), minq_d) <= TOL
    ub_np = np.asarray(ubar_j)
    mq_ref = min(ub_np[2][jmask].min(),
                 np.asarray(jeuler.pressure(ubar_j))[jmask].min())
    assert rel(mq_ref, minq) <= TOL
    # a negative solid cell does not trip the flag, a negative fluid cell does
    for cell, bad in ((np.argwhere(~jmask)[0], False),
                      (np.argwhere(jmask)[0], True)):
        ub = ub_np.copy()
        ub[2][tuple(cell)] = -1.0
        jflag = bool(jpos.negative_average_flag(jnp.asarray(ub), mask=fm))
        tflag = bool(positivity.negative_average_flag(torch.from_numpy(ub),
                                                      mask=mask_t))
        assert jflag == tflag == bad


def test_forward_step_config_runs_through_the_port_solver(config):
    """cli.build_solver on the cut config: the fused forms, the mask and the
    limiter indicator reach the Solver; one step runs."""
    tp = config[4]
    s, mask = cli.build_solver(tp, dtype=F64, device="cpu")
    assert (s.volume_kernel, s.post_kernel) == ("fused", "fused")
    assert s.rhs.ops.flux == "lxf" and s._post_ops.mark_all
    assert np.array_equal(mask, config[2])
    u = cli.set_ic(tp, s)
    with contextlib.redirect_stdout(io.StringIO()):
        u1, t, it = s.run(u, 1.0, max_steps=1)
    assert it == 1 and bool(torch.isfinite(u1).all())


@pytest.mark.parametrize("forms", (("pallas", "fused"), ("xla", "xla")))
def test_solver_forms_agree(config, forms):
    """Solver(volume_kernel=..., post_kernel=...): two masked forward-step
    steps through the plain residual (its volume term through
    volume_residual for "pallas") and the plain post chain end where the
    fused forms' plain versions do, to 1e-12."""
    tp, tmesh, tbcs = config[4:]
    lim = LimiterConfig(type="TVB", shock_indicator="limiter", beta=2.0,
                        char_lim=True, pos_lim=True)
    out = []
    for vk, pk in (("fused", "fused"), forms):
        s = Solver(make_basis("Qk", 1), tmesh, tbcs, flux="lxf", limiter=lim,
                   cfl=0.5, mask=config[2], dtype=F64, device="cpu",
                   volume_kernel=vk, post_kernel=pk)
        assert (s.volume_kernel, s.post_kernel) == (vk, pk)
        out.append(s.run(cli.set_ic(tp, s), 1.0, max_steps=2))
    (ua, ta, na), (ub, tb, nb) = out
    assert na == nb == 2 and tb == pytest.approx(ta, rel=1e-14)
    assert rel(ua.numpy(), ub) <= TOL
