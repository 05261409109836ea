"""The port's implicit path against the JAX package's, in float64 on the CPU.

- GMRES: solver/implicit.gmres against jax.scipy.sparse.linalg.gmres
  (solve_method="batched") on a fixed nonsymmetric system (numpy seed),
  with and without a preconditioner, to 1e-12.
- Newton steps (make_implicit_step) on the Gaussian bump of
  tests/test_implicit.py:83-110 at 16 x 8 (Q1, roe): theta 1 with no
  preconditioner, a global dt and two Newton iterations; theta 0.5 with
  block-Jacobi from lagged dR/du blocks (probe_rhs_blocks, themselves held
  to JAX's); the state to 1e-10, equal NewtonInfo iterations.
- Solver.run (the port's form of tests/test_implicit.py:268): the periodic
  isentropic vortex at 16 x 8, theta 0.5, a global dt and the Newton
  predictor, at chunk 1 and chunk 16 against dflo_tpu's run.
- run_steady: 20 pseudo-transient steps of the bump (local dt,
  block-Jacobi, CFL ramp) against dflo_tpu's history to 1e-8 relative; the
  per-cell dt and the non-lagged block-Jacobi ride on it.
- The post after every Newton update: three implicit steps of the bump
  with the TVB limiter on Gauss Q1 (the port's fused post) against
  dflo_tpu's, to 1e-10.
- The CLI: a steady prm (the bump at 16 x 16: Q1, roe, `method = gmres`,
  `stationary = true`, local dt, the settings of examples/naca0012.prm)
  through `python -m dflo_tpu_torch` and `python -m dflo_tpu --platform cpu
  --x64` with --max-steps 10: grid-sequenced (run_steady_sequenced, 8 x 8
  first), the final checkpoints to 1e-10.  And an explicit RK run
  (examples/vortex_system_pbc.prm at 16 x 16: Q1, lxf, TVB) with `time step
  type = local` and with a fixed `time step`, against the JAX CLI to 1e-10.

Each JAX solver or step is built once per module; its first call compiles.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import cli as jcli
from dflo_tpu import ic as jic
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import implicit as jimplicit
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu_torch import cli
from dflo_tpu_torch.driver import Solver
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver import implicit
from dflo_tpu_torch.solver.rk import compute_dt
from dflo_tpu_torch.solver.spatial import (BoundarySide, cell_averages,
                                           make_rhs)

F64 = torch.float64
FAR = (0.5, 0.0, 1.0, 2.6)


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precondition", (False, True))
def test_gmres_matches_jax(precondition):
    rng = np.random.default_rng(5)
    n = 40
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n))     # nonsymmetric
    b = rng.standard_normal(n)
    Mi = np.linalg.inv(np.diag(np.diag(A)) + np.tril(A, -1)) \
        if precondition else None
    kw = dict(tol=1e-9, restart=8, maxiter=4)
    ref = jax.scipy.sparse.linalg.gmres(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        M=(lambda v: jnp.asarray(Mi) @ v) if precondition else None,
        solve_method="batched", **kw)[0]
    counts = implicit.KrylovCounts()
    At, Mt = torch.from_numpy(A), (torch.from_numpy(Mi) if precondition
                                   else None)
    x = implicit.gmres(lambda v: At @ v, torch.from_numpy(b),
                       (lambda v: Mt @ v) if precondition else None,
                       counts=counts, **kw)
    assert rel(np.asarray(ref)[None], x.numpy()[None]) <= 1e-12
    # one host read before each restart and one after the last
    assert 1 <= counts.restarts <= 4
    assert counts.host_reads in (counts.restarts, counts.restarts + 1)


# ---------------------------------------------------------------------------
# Newton steps, run_steady and Solver.run
# ---------------------------------------------------------------------------

def jax_bump_bcs():
    far = lambda x, y, t: jnp.stack(  # noqa: E731
        [jnp.full_like(x, v) for v in FAR])
    return dict(W=jspatial.BoundarySide(jeuler.BC_FARFIELD, far),
                E=jspatial.BoundarySide(jeuler.BC_FARFIELD, far),
                S=jspatial.BoundarySide(jeuler.BC_SLIP),
                N=jspatial.BoundarySide(jeuler.BC_SLIP))


def bump_bcs():
    def far(x, y, t):
        return torch.stack([torch.full_like(x, v) for v in FAR])
    return dict(W=BoundarySide(euler.BC_FARFIELD, far),
                E=BoundarySide(euler.BC_FARFIELD, far),
                S=BoundarySide(euler.BC_SLIP), N=BoundarySide(euler.BC_SLIP))


def jax_bump(x, y, t=0.0):
    b = 0.05 * jnp.exp(-50 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    return jnp.stack([0.5 + b, b, 1.0 + b, jnp.full_like(x, 2.6)])


@pytest.fixture(scope="module")
def bump():
    """(JAX basis, mesh, rhs, u0 as numpy) of the bump at 16 x 8."""
    jb = jax_make_basis("Qk", 1)
    jm = JMesh(16, 8, 0.0, 1.0, 0.0, 1.0)
    rhs = jspatial.make_rhs(jb, jm, jax_bump_bcs(), flux="roe")
    return jb, jm, rhs, np.asarray(jic.set_initial_condition(jb, jm,
                                                             jax_bump))


def port_rhs():
    return make_rhs(make_basis("Qk", 1), CartesianMesh(16, 8, 0.0, 1.0, 0.0,
                                                       1.0),
                    bump_bcs(), flux="roe", dtype=F64, device="cpu")


#: case -> (theta, precondition, max_newton, lagged)
STEP_CASES = {"theta1-plain-newton2": (1.0, None, 2, False),
              "theta05-lagged-jacobi": (0.5, "block_jacobi", 2, True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_newton_step_matches_jax(bump, case):
    theta, pc, newton, lagged = STEP_CASES[case]
    jb, jm, jrhs, u0 = bump
    dt = 20.0 * float(compute_dt(cell_averages(make_basis("Qk", 1),
                                               torch.from_numpy(u0.copy())),
                                 CartesianMesh(16, 8, 0.0, 1.0, 0.0, 1.0),
                                 1, 1.0))
    kw = dict(theta=theta, max_newton=newton, lin_tol=1e-6, gmres_restart=10,
              gmres_maxiter=3, precondition=pc)
    jstep = jimplicit.make_implicit_step(jrhs, **kw)
    rhs = port_rhs()
    step = implicit.make_implicit_step(rhs, **kw)
    u = torch.from_numpy(u0.copy())
    if lagged:
        jr = jax.jit(lambda v: jimplicit.probe_rhs_blocks(jrhs, v, 0.0))(
            jnp.asarray(u0))
        tr = implicit.probe_rhs_blocks(rhs, u, 0.0)
        assert rel(np.asarray(jr).reshape(1, -1),
                   tr.numpy().reshape(1, -1)) <= 1e-12
        ju, jinfo = jax.jit(lambda v: jstep(v, 0.0, dt, jr_blocks=jr))(
            jnp.asarray(u0))
        tu, tinfo = step(u, 0.0, dt, jr_blocks=tr)
    else:
        ju, jinfo = jax.jit(lambda v: jstep(v, 0.0, dt))(jnp.asarray(u0))
        tu, tinfo = step(u, 0.0, dt)
    assert int(jinfo.iters) == int(tinfo.iters) == newton
    assert rel(ju, tu.numpy()) <= 1e-10
    assert abs(float(jinfo.res0) - float(tinfo.res0)) <= 1e-12 * float(
        jinfo.res0)
    assert not bool(tinfo.diverged)
    c = step.counts
    assert c.newton == newton and c.restarts >= newton
    assert c.host_reads >= c.restarts


def test_run_steady_matches_jax(bump):
    """20 steps of local-dt PTC with block-Jacobi from CFL 2 (the linear
    solves converge on every step, so round-off stays round-off): the
    residual history to 1e-8 relative, the state to 1e-8."""
    jb, jm, _, u0 = bump
    kw = dict(flux="roe", cfl=2.0, method="implicit", max_nonlin_iter=1,
              linear_residual=1e-4, precondition="block_jacobi")
    js = JSolver(jb, jm, jax_bump_bcs(), **kw)
    ju, jhist = jimplicit.run_steady(js, jnp.asarray(u0), cfl0=2.0,
                                     min_residual=1e-12, max_steps=20)
    s = Solver(make_basis("Qk", 1), CartesianMesh(16, 8, 0.0, 1.0, 0.0, 1.0),
               bump_bcs(), dtype=F64, device="cpu", **kw)
    tu, thist = implicit.run_steady(s, torch.from_numpy(u0.copy()),
                                    cfl0=2.0, min_residual=1e-12,
                                    max_steps=20)
    assert len(thist) == len(jhist) == 20
    assert thist[-1] < 0.05 * thist[0]
    assert np.abs(np.array(thist) / np.array(jhist) - 1.0).max() <= 1e-8
    assert rel(ju, tu.numpy()) <= 1e-8
    c = s.krylov_counts
    assert c.host_reads >= 20 and c.tangents > c.restarts


def test_solver_run_chunked_matches_jax():
    """Implicit global stepping with the Newton predictor carried across
    steps: the port's host loop (chunk 1) and chunked loop (chunk 16)
    against dflo_tpu's run (tests/test_implicit.py:268)."""
    per = jspatial.BoundarySide(jeuler.BC_PERIODIC)
    kw = dict(flux="roe", cfl=2.0, method="implicit", theta=0.5,
              max_nonlin_iter=3, linear_residual=1e-8)
    js = JSolver(jax_make_basis("Qk", 1), JMesh(16, 8, -5.0, 5.0, -2.5, 2.5),
                 dict(W=per, E=per, S=per, N=per), **kw)
    u0 = np.asarray(jic.set_initial_condition(js.basis, js.mesh,
                                              jic.isentropic_vortex()))
    ju, jt, jit_ = js.run(jnp.asarray(u0), 0.2, chunk=1)
    tper = BoundarySide(euler.BC_PERIODIC)
    s = Solver(make_basis("Qk", 1), CartesianMesh(16, 8, -5.0, 5.0, -2.5,
                                                  2.5),
               dict(W=tper, E=tper, S=tper, N=tper), dtype=F64, device="cpu",
               **kw)
    for chunk in (1, 16):
        tu, tt, tit = s.run(torch.from_numpy(u0.copy()), 0.2, chunk=chunk)
        assert tit == jit_
        assert abs(tt - jt) <= 1e-13
        assert rel(ju, tu.numpy()) <= 1e-10, chunk
        assert isinstance(s.last_stats, implicit.NewtonInfo)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

STEADY_PRM = """# the bump relaxed to its free stream by pseudo-transient continuation
subsection cartesian mesh
   set nx = 16
   set ny = 16
   set x0 = 0.0
   set x1 = 1.0
   set y0 = 0.0
   set y1 = 1.0
end
set degree = 1
subsection boundary_1
   set type = slip
end
subsection boundary_3
   set type = slip
end
subsection boundary_2
   set type = farfield
   set w_0 value = 0.5
   set w_1 value = 0.0
   set w_2 value = 1.0
   set w_3 value = 2.6
end
subsection boundary_4
   set type = farfield
   set w_0 value = 0.5
   set w_1 value = 0.0
   set w_2 value = 1.0
   set w_3 value = 2.6
end
subsection initial condition
   set w_0 value = 0.5 + 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_1 value = 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_2 value = 1.0 + 0.05*exp(-50*((x-0.5)^2 + (y-0.5)^2))
   set w_3 value = 2.6
end
subsection time stepping
   set time step type = local
   set cfl = 2.0
   set stationary = true
   set nonlinear iterations = 1
   set min residual = 1.0e-10
end
subsection linear solver
   set method = gmres
   set residual = 1.0e-4
end
subsection refinement
   set refinement = false
end
subsection flux
   set flux = roe
end
subsection limiter
   set type = none
end
"""


def ckpt(d, i):
    with np.load(os.path.join(d, f"checkpoint-{i:03d}.npz")) as z:
        return {k: z[k] for k in z.files}


def both_clis(root, prm_text, name, steps):
    """Run the JAX CLI and the port's on the prm; returns (JAX output
    dir, port output dir, the port's CliRun)."""
    prm = root / f"{name}.prm"
    prm.write_text(prm_text)
    common = [str(prm), "--platform", "cpu", "--x64", "--max-steps",
              str(steps), "--checkpoint-every", "1"]
    jout, tout = root / f"{name}_jax", root / f"{name}_port"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(common + ["--output-dir", str(jout)]) == 0
        res = cli.run(common + ["--output-dir", str(tout)])
    return str(jout), str(tout), res


def test_steady_cli_matches_jax(tmp_path):
    jout, tout, res = both_clis(tmp_path, STEADY_PRM, "steady", 10)
    assert [len(h) for h in res.steady_levels] == [10, 10]
    assert res.solver.steady_coarse.mesh.nx == 8
    assert res.it == 20
    for i in (0, 1):
        assert rel(ckpt(jout, i)["u"], ckpt(tout, i)["u"]) <= 1e-10
    # the fine level starts from the prolonged coarse state and relaxes
    fine = res.steady_levels[1]
    assert fine[-1] < fine[0]


def pbc_prm(edit: dict) -> str:
    src = open("examples/vortex_system_pbc.prm").read()
    src = src.replace("nx = 100", "nx = 16").replace("ny = 100", "ny = 16")
    for a, b in edit.items():
        assert a in src
        src = src.replace(a, b)
    return src


@pytest.mark.parametrize("kind", ("local", "fixed"))
def test_explicit_dt_kinds_match_jax(tmp_path, kind):
    edit = ({"time step type = global": "time step type = local"}
            if kind == "local" else
            {"set cfl = 0.9": "set cfl = 0.0\n  set time step = 0.002"})
    jout, tout, res = both_clis(tmp_path, pbc_prm(edit), kind, 6)
    assert res.it == 6
    a, b = ckpt(jout, 1), ckpt(tout, 1)
    assert rel(a["u"], b["u"]) <= 1e-10
    assert abs(float(a["t"]) - float(b["t"])) <= 1e-14
    if kind == "fixed":
        assert abs(float(b["t"]) - 6 * 0.002) <= 1e-14


def test_implicit_with_tvb_post_matches_jax(bump):
    """The stabilization chain after every Newton update (src/claw.cc:
    905-911): on Gauss Q1 with the TVB limiter the port runs its fused
    post (the plain twin here), dflo_tpu its XLA chain; three implicit
    steps of the bump to 1e-10."""
    from dflo_tpu.driver import LimiterConfig as JLimiter
    from dflo_tpu_torch.driver import LimiterConfig
    jb, jm, _, u0 = bump
    lim = dict(type="TVB", shock_indicator="density", beta=2.0,
               char_lim=True, pos_lim=True)
    kw = dict(flux="roe", cfl=5.0, method="implicit", max_nonlin_iter=2,
              linear_residual=1e-6, precondition="block_jacobi")
    js = JSolver(jb, jm, jax_bump_bcs(), limiter=JLimiter(**lim), **kw)
    ju, jt, jn = js.run(jnp.asarray(u0), 1.0, max_steps=3)
    s = Solver(make_basis("Qk", 1), CartesianMesh(16, 8, 0.0, 1.0, 0.0, 1.0),
               bump_bcs(), limiter=LimiterConfig(**lim), dtype=F64,
               device="cpu", **kw)
    assert (s.volume_kernel, s.post_kernel) == ("fused", "fused")
    tu, tt, tn = s.run(torch.from_numpy(u0.copy()), 1.0, max_steps=3)
    assert tn == jn == 3 and abs(tt - jt) <= 1e-13
    assert rel(ju, tu.numpy()) <= 1e-10
