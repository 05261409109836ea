"""The port's masked modal Pk path against the JAX package's, on the CPU in
float64.

The configuration is examples/forward_step_tpu.prm edited to the modal P2
basis (`basis = Pk`, `degree = 2`) and cut to 48 x 16 cells: the 3 x 1 box
with the solid step (x>0.6)*(y<0.2), LxF, characteristic TVB (beta 2, the
`limiter` indicator), positivity, inflow W, outflow E, slip S and N, set up
by each package's own config layer and CLI builders.

- The residual: the port's fused residual (its plain version on the CPU,
  with its delta strips) on a perturbed modal state against dflo_tpu's
  make_rhs(..., mask=mask) on Pk, for p = 1, 2, 3 and all six fluxes, in its
  R, u + dt*R and SSP-stage forms (the last two against the JAX residual
  blended in numpy): 1e-12 relative per component, and a solid cell's R
  exactly 0.  The reference's XLA residual is the yardstick, except for
  kfvs, whose kernel evaluates erf by the Abramowitz-Stegun form
  (pallas_kernels.py:272-273): there it is the reference's fused residual
  (its Pallas kernel in interpret mode).  The state is the inflow state
  with 2 % noise on mode 0 and 0.3 % of it on the higher modes (numpy rng:
  every point value stays physical),
  solid cells at the benign state (0, 0, 1, 2.5) as a constant (mode 0).
  Solver.apply_mask writes that state into every mode, in both packages,
  which is no constant on the modal basis: its face traces can hold a
  negative density, where the fluxes give NaN and R * mask keeps it, in
  both packages; the solvers positivity-limit every cell after pinning,
  before the next residual (ROADMAP queue 3).
- The solver: 5 steps of Solver(method="rk") and of Solver(method="mood")
  on P2 from the same post-staged initial state against dflo_tpu's jitted
  Solver._step: every step's state within 1e-10 relative per component (a
  component below a millionth of the state's largest magnitude measured
  against that millionth), its dt within 1e-13, and for MOOD equal MoodStats
  per step, with the cascade firing.  No cell reaches the f64 pressure floor
  of ROADMAP queue 3 in these steps (every step agrees to 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import cli as jcli
from dflo_tpu.config.params import AllParameters as JParams
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import cli, interop
from dflo_tpu_torch.config.params import AllParameters
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.solver.spatial import make_rhs

F64 = torch.float64
NX, NY = 48, 16
STEPS = 5
TOL = 1e-10
FLUXES = ("hllc", "lxf", "roe", "sw", "kfvs", "kep")


def rel(ref, x) -> float:
    """max over components of max|ref - x| / max|ref|, a component's scale
    at least a millionth of the state's largest magnitude."""
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    mags = np.abs(ref).reshape(4, -1).max(1)
    scale = np.maximum(mags, max(1e-6 * mags.max(), 1e-300))
    return float((np.abs(ref - x).reshape(4, -1).max(1) / scale).max())


def prm_text(method: str) -> str:
    src = open("examples/forward_step_tpu.prm").read()
    for a, b in (("nx = 1920", f"nx = {NX}"), ("ny = 640", f"ny = {NY}"),
                 ("set degree = 1", "set degree = 2\nset basis = Pk"),
                 ("set method = rk3", f"set method = {method}")):
        assert a in src
        src = src.replace(a, b)
    return src


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """method -> (the JAX package's parameters, the port's)."""
    root = tmp_path_factory.mktemp("fs_pk")
    out = {}
    for method in ("rk3", "mood"):
        prm = root / f"{method}.prm"
        prm.write_text(prm_text(method))
        out[method] = (JParams.from_prm_file(str(prm)),
                       AllParameters.from_prm_file(str(prm)))
    return out


def modal_state(p: int, seed: int, mask) -> np.ndarray:
    K = (p + 1) * (p + 2) // 2
    base = np.array([4.2, 0.5, 1.4, 8.8])[:, None, None, None]
    rng = np.random.default_rng(seed)
    u = np.zeros((4, K, NY, NX))
    u[:, :1] = base * (1.0 + 0.02 * rng.uniform(-1.0, 1.0, (4, 1, NY, NX)))
    u[:, 1:] = base * 0.003 * rng.uniform(-1.0, 1.0, (4, K - 1, NY, NX))
    solid = np.zeros((4, K, 1, 1))
    solid[:, 0, 0, 0] = 0.0, 0.0, 1.0, 2.5
    return np.where(mask[None, None], u, solid)


@pytest.mark.parametrize("p", (1, 2, 3))
@pytest.mark.parametrize("flux", FLUXES)
def test_masked_modal_residual_matches_jax(params, flux, p):
    jp, tp = params["rk3"]
    jmesh, jmask, jbids = jcli.build_domain(jp)
    tmesh, tmask, tbids = cli.build_domain(tp)
    assert np.array_equal(jmask, tmask) and not tmask.all()
    u_np = modal_state(p, 20 + p, tmask)
    jrhs = jspatial.make_rhs(
        jax_make_basis("Pk", p), jmesh, jcli.build_bcs(jp, jbids), flux=flux,
        mask=jmask, dtype=jnp.float64,
        volume_kernel="fused" if flux == "kfvs" else "xla")
    t = 0.125
    ref = np.asarray(jrhs(jnp.asarray(u_np), t))
    rhs = make_rhs(make_basis("Pk", p), tmesh, cli.build_bcs(tp, tbids),
                   flux=flux, dtype=F64, device="cpu",
                   volume_kernel="fused", mask=tmask)
    # a masked residual has no sparse candidate (the dense MOOD route)
    assert rhs.modal_ops is not None
    assert not hasattr(rhs, "sparse_candidate")
    u = torch.from_numpy(u_np)
    strips = rhs.strips(u, t)
    R = kernels.fused_residual(u, *strips, rhs.ops)
    assert np.isfinite(ref).all()
    assert rel(ref, R) <= 1e-12
    assert float(R[..., ~torch.from_numpy(tmask)].abs().max()) == 0.0
    h, a = 1e-3, 0.75
    u_old = np.flip(u_np, -1).copy()
    step = kernels.fused_residual(u, *strips, rhs.ops,
                                  dt=torch.tensor(h, dtype=F64))
    assert rel(u_np + h * ref, step) <= 1e-12
    stage = kernels.fused_residual(u, *strips, rhs.ops,
                                   u_old=torch.from_numpy(u_old),
                                   sc=torch.tensor([a, h], dtype=F64))
    assert rel(a * u_old + (1.0 - a) * (u_np + h * ref), stage) <= 1e-12
    solid = ~torch.from_numpy(tmask)
    assert torch.equal(step[..., solid], u[..., solid])


def solver_steps(params, method: str):
    """(the port's states, dts and MoodStats over STEPS steps of _step, the
    JAX package's) from the port's post-staged initial state."""
    jp, tp = params[method]
    js, _ = jcli.build_solver(jp)
    ts, _ = cli.build_solver(tp, dtype=F64, device="cpu")
    assert ts.basis.family == "Pk" and ts.mask is not None
    u = ts.post_stage(cli.set_ic(tp, ts))
    ju, t, jt = jnp.asarray(u.numpy()), 0.0, 0.0
    port, ref = [], []
    for _ in range(STEPS):
        u, dt, bad, st = ts._step(u, t, 1.0)
        t += float(dt)
        port.append((u.numpy(), float(dt), bool(bad),
                     interop.stats_as_numpy(st) if st else None))
        ju, jdt, jbad, jst = js._step(ju, jnp.asarray(jt),
                                      jnp.asarray(1.0))
        jt += float(jdt)
        ref.append((np.asarray(ju), float(jdt), bool(jbad),
                    interop.stats_as_numpy(jst) if jst else None))
    return port, ref


def test_masked_pk_rk_solver_matches_jax(params):
    port, ref = solver_steps(params, "rk3")
    for k, (p, r) in enumerate(zip(port, ref)):
        assert not p[2] and not r[2]
        assert abs(p[1] - r[1]) <= 1e-13 * r[1], k
        assert rel(r[0], p[0]) <= TOL, (k, rel(r[0], p[0]))
        assert np.isfinite(p[0]).all()


def test_masked_pk_mood_solver_matches_jax(params):
    port, ref = solver_steps(params, "mood")
    for k, (p, r) in enumerate(zip(port, ref)):
        assert not p[2] and not r[2]
        assert abs(p[1] - r[1]) <= 1e-13 * r[1], k
        assert rel(r[0], p[0]) <= TOL, (k, rel(r[0], p[0]))
        assert np.array_equal(p[3], r[3]), (k, p[3], r[3])
    assert sum(int(p[3][0]) for p in port) > 0          # the cascade fired
    assert np.isfinite(port[-1][0]).all()
