"""The MOOD stage's options and its plain arm against the JAX package's
make_mood, in float64 on the CPU.

The predictor is the DMR state after post_stage at 32 x 8 (the input of
tests/test_torch_mood.py); dflo_tpu's stages are jitted once each (a
module fixture) and hold the JAX package's CPU path, its plain candidate
{truncation -> positivity} + dt * R and its plain check.

- ``dmp_bounds="collapsed"`` (every cell's DMP interval its own mean, the
  bounds the reference's loop executes): the port's fused route and its
  plain arm (the Solver built with ``volume_kernel="xla"``) against
  dflo_tpu's stage with the same bounds; and the collapsed bounds reduce
  a superset of the neighborhood's cells.
- The warm start ``deg_in`` (a seeded random degree map, and the map of
  full degree): both routes against dflo_tpu's stage with the same map,
  which then returns its settled map too.
- The cold stage on the plain arm against dflo_tpu's.
- Three steps of the fused cascade with the stage's post off the fused Pk
  post (limiter none; TVB with angular momentum), as the cases of
  tests/test_torch_mood_routes.py.

Each comparison: equal limiter maps, degree maps and MoodStats, and the
candidates within 1e-10 relative except around the five cells where the
full-degree {truncation -> positivity} chain moves the predictor: there
Zhang-Shu takes its f64 pressure-floor branch, which rounding decides, and
dflo_tpu's jitted stage rounds otherwise than its eager ops
(tests/test_torch_mood.py, ROADMAP "Faults found").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.stab import mood as jmood
from dflo_tpu_torch import entry, interop
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.stab import mood as tmood

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-10
DT = 4e-4


def tdt(x):
    return torch.tensor(x, dtype=F64)


def jscalar(x):
    return jnp.asarray(x, jnp.float64)


@pytest.fixture(scope="module")
def dmr():
    """dflo_tpu's DMR MOOD solver, its predictor, its jitted stages (the
    default one and the collapsed one), and the port's solvers on the fused
    route and on the plain residual."""
    js, u0 = graft._build(NX, NY, method="mood")
    u_pre = np.asarray(jax.jit(js.post_stage)(u0))
    collapsed = jmood.make_mood(js.basis, js.mesh, js.rhs, dtype=jnp.float64,
                                positivity=js._positivity,
                                dmp_bounds="collapsed")
    stages = {"neighborhood": jax.jit(js._mood_stage),
              "collapsed": jax.jit(collapsed)}
    ts, _ = entry._build(NX, NY, device="cpu", method="mood")
    tx, _ = entry._build(NX, NY, device="cpu", method="mood",
                         volume_kernel="xla")
    assert ts._mood_stage.fused and not tx._mood_stage.fused
    return stages, u_pre, {"fused": ts, "plain": tx}


def port_stage(solver, bounds):
    if bounds == "neighborhood":
        return solver._mood_stage
    return tmood.make_mood(solver.basis, solver.mesh, solver.rhs,
                           dmp_bounds=bounds)


def near_floor(solver, u):
    """The cells where the full-degree chain moves the predictor, and their
    face neighbors (bool numpy [ny, nx])."""
    mops = kernels.modal_operators(solver.basis, solver.mesh, dtype=F64,
                                   device="cpu")
    moved = (kernels.fused_modal_pos(u, mops) != u).flatten(0, 1).any(0)
    return tmood.dilate4(moved).numpy()


def compare(ref, got, near):
    cj, lj, sj = ref[:3]
    ct, lt, st, dt_ = got
    assert np.array_equal(np.asarray(lj), lt.numpy())
    assert np.array_equal(interop.stats_as_numpy(sj),
                          interop.stats_as_numpy(st))
    if len(ref) == 4:
        assert np.array_equal(np.asarray(ref[3]), dt_.numpy())
    scale = np.abs(np.asarray(cj)).max()
    err = np.abs(np.asarray(cj) - ct.numpy()).max(axis=(0, 1)) / scale
    assert err[~near].max() <= TOL


@pytest.mark.parametrize("route", ("fused", "plain"))
@pytest.mark.parametrize("bounds", ("neighborhood", "collapsed"))
def test_stage_bounds_match_jax(dmr, bounds, route):
    stages, u_pre, solvers = dmr
    s = solvers[route]
    u = interop.state_from_numpy(u_pre, F64, "cpu")
    ref = stages[bounds](jnp.asarray(u_pre), jscalar(0.0), jscalar(DT))
    got = port_stage(s, bounds)(u, tdt(0.0), tdt(DT))
    compare(ref, got, near_floor(s, u))
    assert got[2].iters >= 2 and int(got[2].n_reduce) > 0
    if bounds == "collapsed":
        # the collapsed interval fails a superset of the cells
        cold = s._mood_stage(u, tdt(0.0), tdt(DT))
        assert int(got[2].n_reduce) >= int(cold[2].n_reduce)
        assert bool((got[3] <= cold[3]).all())


@pytest.mark.parametrize("route", ("fused", "plain"))
@pytest.mark.parametrize("start", ("random", "full"))
def test_warm_start_matches_jax(dmr, start, route):
    stages, u_pre, solvers = dmr
    s = solvers[route]
    p = s.basis.degree
    rng = np.random.default_rng(7)
    deg = (rng.integers(1, p + 1, (NY, NX)) if start == "random"
           else np.full((NY, NX), p)).astype(np.int32)
    u = interop.state_from_numpy(u_pre, F64, "cpu")
    ref = stages["neighborhood"](jnp.asarray(u_pre), jscalar(0.0),
                                 jscalar(DT), jnp.asarray(deg))
    assert len(ref) == 4
    got = s._mood_stage(u, tdt(0.0), tdt(DT), deg_in=torch.from_numpy(deg))
    compare(ref, got, near_floor(s, u))
    if start == "random":
        # cells that start below p keep at most their start degree
        assert bool((got[3] <= torch.from_numpy(deg)).all())


@pytest.mark.parametrize("case", ("limiter_none", "angular_momentum"))
def test_fused_cascade_post_routes_match_jax(case):
    from test_torch_mood_routes import check_case
    check_case(case)
