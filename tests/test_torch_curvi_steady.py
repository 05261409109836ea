"""The port's implicit path on a curvilinear block against the JAX
package's, in float64 on the CPU (the steady part of tests/
test_torch_curvi.py, a file of its own so that the two run side by side).

The implicit path: a 32 x 8 NACA 0012 O-mesh (mesh.curvilinear.
naca0012_omesh, written as a .struct) through the port's cli.run with
examples/naca0012.prm's settings, against dflo_tpu's CLI builders and its
grid-sequenced PTC (dflo_tpu/cli.py:579-596): the ||R|| histories and the
state within 1e-10, the same Newton counts and the same unconverged linear
solves.  Two cases:

- cfl 0.25, 2 PTC steps on each level: every linear solve converges;
- the config's cfl 2, 1 PTC step on each level: the fine level's GMRES
  stops unconverged at its 10 restarts, the regime of the naca0012 run on
  the card.  A second step there carries the two residuals' round-off
  through 300 more Krylov iterations to about 1e-9.

The reference's run_steady jits its per-level step anew on every call
(about 25 s a level, most of this file's time), so the reference side here
is its loop (dflo_tpu/solver/implicit.py:399-436 around :330-345) with that
step compiled once per level, shared by the two cases, and compiled in two
threads while the port runs both cases.

load_struct: the port's reader gives the reference's arrays on the written
O-mesh, and flips a block written the other way round as the reference
does.
"""

import concurrent.futures
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dflo_tpu import cli as jcli
from dflo_tpu.amr import make_prolong, make_restrict
from dflo_tpu.config.params import AllParameters as JParams
from dflo_tpu.mesh import curvilinear as jcurvi
from dflo_tpu.physics import euler as jeuler
from dflo_tpu_torch import cli
from dflo_tpu_torch.mesh.curvilinear import (CurvilinearMesh, load_struct,
                                             naca0012_omesh, write_struct)


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


STEADY_PRM = """
set mesh type = gmsh
set mesh file = naca.struct
set degree = 1
set mapping = q1
subsection boundary_0
   set type = slip
end
subsection boundary_1
   set type = farfield
   set w_0 value = 0.6296158
   set w_1 value = 0.0219908
   set w_2 value = 1.0
   set w_3 value = 1.9841269
end
subsection initial condition
   set w_0 value = 0.6296158
   set w_1 value = 0.0219908
   set w_2 value = 1.0
   set w_3 value = 1.9841269
end
subsection time stepping
   set time step type = local
   set cfl = {cfl}
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


#: the linear solver's relative tolerance in STEADY_PRM
LIN_TOL = 1e-4
#: (cfl, PTC steps a level) of the two cases
CASES = ((0.25, 2), (2, 1))


@pytest.fixture(scope="module")
def naca_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("naca")
    write_struct(str(d / "naca.struct"), naca0012_omesh(32, 8))
    for cfl, _ in CASES:
        (d / f"naca_cfl{cfl}.prm").write_text(STEADY_PRM.format(cfl=cfl))
    return d


def _level_step(solver, u):
    """The reference's per-level PTC step, run_steady's `one`
    (dflo_tpu/solver/implicit.py:330-345) on a curvilinear block: the
    per-cell dt from cell_h, one backward-Euler Newton step, ||R|| of the
    result; compiled for states like u, with cfl an argument."""
    h_field = jnp.asarray(solver.mesh.cell_h())
    step = solver._implicit_step

    @jax.jit
    def one(u, cfl):
        lam = jeuler.max_eigenvalue(solver.cell_averages(u))
        dtc = h_field / lam / (2.0 * solver.basis.degree + 1.0)
        u_new, info = step(u, 0.0, dtc * cfl)
        return u_new, jnp.sqrt(jnp.sum(solver.rhs(u_new, 0.0) ** 2)), info

    return one.lower(u, 1.0).compile()


@pytest.fixture(scope="module")
def reference(naca_dir):
    """dflo_tpu's solver pair from its CLI builders, its initial state and
    the futures of each level's compiled step (coarse, fine)."""
    params = JParams.from_prm_file(str(naca_dir / "naca_cfl2.prm"))
    js, _ = jcli.build_solver(params, str(naca_dir))
    assert js.steady_coarse is not None
    u0 = jcli.set_ic(params, js)
    uc = make_restrict(js.basis, u0.dtype)(u0)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield js, u0, (pool.submit(_level_step, js.steady_coarse, uc),
                       pool.submit(_level_step, js, u0))


def reference_sequenced(js, u, ones, cfl0: float, steps: int):
    """dflo_tpu's run_steady_sequenced (dflo_tpu/solver/implicit.py:399-436,
    run_steady's loop at :347-387) through the shared level steps: restrict,
    `steps` PTC steps with the CFL ramp, prolong, `steps` more.  Returns
    (u, ||R|| history, Newton iterations per level, unconverged linear
    solves)."""
    hist, newton, warnings = [], [], 0
    u = make_restrict(js.basis, u.dtype)(u)
    for level, future in enumerate(ones):
        one = future.result()
        if level:
            u = make_prolong(js.basis, u.dtype)(u)
        cfl, h, iters = float(cfl0), [], 0
        for it in range(steps):
            u, res, info = one(u, cfl)
            res = float(res)
            assert not bool(info.diverged) and res == res
            warnings += float(info.lin_res) > LIN_TOL * 1.001
            iters += int(info.iters)
            if it >= 2:
                cfl *= min(max(h[-1] / res, 0.5), 2.0)
            h.append(res)
        hist += h
        newton.append(iters)
    return u, hist, newton, warnings


def test_load_struct_matches_jax(naca_dir):
    path = str(naca_dir / "naca.struct")
    jm, tm = jcurvi.load_struct(path), load_struct(path)
    assert np.array_equal(jm.X, tm.X) and np.array_equal(jm.Y, tm.Y)
    assert float(np.min(tm.metric(np.array([[0.5, 0.5]]))[4])) > 0
    # a block written the other way round is flipped, as the reference's
    flipped = naca_dir / "flipped.struct"
    write_struct(str(flipped), CurvilinearMesh(tm.X[:, ::-1], tm.Y[:, ::-1]))
    jf, tf = jcurvi.load_struct(str(flipped)), load_struct(str(flipped))
    assert np.array_equal(jf.X, tf.X) and np.array_equal(tf.X, tm.X)


@pytest.fixture(scope="module")
def port_runs(naca_dir, reference):
    """The port's cli.run of each case, (result, printed log) by cfl, run
    while the reference's level steps compile."""
    runs = {}
    for cfl, steps in CASES:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            runs[cfl] = cli.run(
                [str(naca_dir / f"naca_cfl{cfl}.prm"), "--platform", "cpu",
                 "--x64", "--max-steps", str(steps), "--output-dir",
                 str(naca_dir / f"out_cfl{cfl}"), "--checkpoint-every",
                 "1"]), log.getvalue()
    return runs


def _steady_matches_jax(naca_dir, reference, port_runs, cfl, steps: int):
    """The port's run of a case against the reference's; returns the
    number of linear solves left unconverged."""
    res, log = port_runs[cfl]
    js, u0, ones = reference
    uj, hj, newton_j, warn_j = reference_sequenced(js, u0, ones, cfl, steps)
    s = res.solver
    assert s.curvilinear and s.steady_coarse.mesh.nx == 16
    assert [len(h) for h in res.steady_levels] == [steps, steps]
    ht = [r for h in res.steady_levels for r in h]
    assert len(ht) == len(hj)
    assert max(abs(a - b) / abs(a) for a, b in zip(hj, ht)) <= 1e-10
    assert rel(uj, res.u) <= 1e-10
    # the same Newton iterations on each level (`nonlinear iterations = 1`:
    # one a PTC step) and the same linear solves left unconverged
    assert [s.steady_coarse.krylov_counts.newton,
            s.krylov_counts.newton] == newton_j == [steps, steps]
    assert log.count("WARNING: linear solver") == warn_j
    with np.load(str(naca_dir / f"out_cfl{cfl}" / "checkpoint-001.npz")) as z:
        assert int(z["nx"]) == 32 and "x0" not in z.files
        assert rel(uj, z["u"]) <= 1e-10
    return warn_j


def test_naca_steady_cli_matches_jax(naca_dir, reference, port_runs):
    """cfl 0.25, 2 PTC steps per level: every linear solve converges."""
    assert _steady_matches_jax(naca_dir, reference, port_runs,
                               *CASES[0]) == 0


def test_naca_steady_cfl2_matches_jax(naca_dir, reference, port_runs):
    """The config's cfl 2, 1 PTC step per level: the fine level's GMRES
    stops unconverged at its restart cap, in both packages."""
    assert _steady_matches_jax(naca_dir, reference, port_runs,
                               *CASES[1]) == 1
