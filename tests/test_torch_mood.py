"""The port's MOOD cascade against the JAX package's, in float64 on the CPU.

- The plane operations (neighborhood min/max, the validity-masked dilation)
  equal dflo_tpu.stab.mood's exactly, periodic and not; the plain check
  gives the degree, limiter and change maps of dflo_tpu's check kernel
  (make_fused_mood_check, interpret mode).
- One mood_stage on the DMR state after post_stage: the same predictor goes
  to dflo_tpu's jitted XLA stage and to the port's.  Equal limiter maps and
  MoodStats; the candidates agree to 1e-10 relative except around cells
  where the full-degree {truncation -> positivity} chain is not the
  identity on the predictor.  There Zhang-Shu takes a branch at the f64
  pressure floor (|1 - t| < 1e-14 -> t = 0) that rounding decides, and
  dflo_tpu's jitted stage and its eager ops round differently from each
  other; the port matches the eager ops (ROADMAP, "Faults found").
- Three steps of Solver._multi_step(3), and of Solver._step, against three
  calls of dflo_tpu's own jitted Solver._step (compute_dt on the mode-0
  means, its _mood_rk_step: per stage the cascade, the blend, TVB on the
  marked cells, positivity) on the same configuration from a contact
  discontinuity in the Mach-10 flow, where the cascade fires and no cell
  sits at that floor: state within 1e-10, same t, 3 steps, no fatal flag,
  equal MoodStats.  On the CPU dflo_tpu's _multi_step is a while_loop over
  this same step (its carry-lambda needs the TPU's fused diag), so three
  _step calls are its three steps; the step alone compiles faster than the
  loop around it.
- Two such steps from the DMR state itself: equal dt and MoodStats, and the
  state within 1e-10 outside columns 0-9, the cells the five pressure-floor
  cells above reach in two steps; the third step's dt already depends on
  them (ROADMAP, "Faults found").
- With the LxF flux: the plain candidate with every cell set against
  dflo_tpu's dense candidate {truncation -> positivity} + dt * R_lxf at
  ragged ny (4 and 10), 1e-12 relative (its dissipation speed reads the
  averages of the tp'd states on both sides of each face); and three MOOD
  steps on the contact discontinuity as above, 1e-10.
- With a body force (euler.GravitySource, g = (0, -1)): the residual's
  gravity arm, so the dense route (no sparse candidate, as the reference's
  candidate takes no source, dflo_tpu/solver/spatial.py:498-499): three
  MOOD steps on the contact discontinuity against dflo_tpu's jitted
  Solver._step with the same force, 1e-10, equal MoodStats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.ops.pallas_kernels import make_fused_mood_check
from dflo_tpu.stab import limiter as jlim
from dflo_tpu.stab import mood as jmood
from dflo_tpu_torch import entry, interop
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.stab import mood as tmood
from dflo_tpu_torch.stab.limiter import neighbor_valid

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-10
PERS = ((False, False), (True, False), (False, True), (True, True))


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def tdt(x):
    return torch.tensor(x, dtype=F64)


@pytest.mark.parametrize("per", PERS)
def test_plane_ops_match_jax(per):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((NY, NX))
    flag = rng.uniform(size=(NY, NX)) < 0.1
    vj = tuple(jnp.asarray(v) for v in jlim.neighbor_valid((NY, NX), *per))
    vt = tuple(torch.from_numpy(v) for v in neighbor_valid((NY, NX), *per))
    pairs = ((jmood.neighborhood_min(jnp.asarray(a), vj),
              tmood.neighborhood_min(torch.from_numpy(a), vt)),
             (jmood.neighborhood_max(jnp.asarray(a), vj),
              tmood.neighborhood_max(torch.from_numpy(a), vt)),
             (jmood.dilate4_valid(jnp.asarray(flag), vj),
              tmood.dilate4_valid(torch.from_numpy(flag), vt)))
    for ref, got in pairs:
        assert np.array_equal(np.asarray(ref), got.numpy())
    # non-periodic sides do not wrap: a flag in column 0 stays off column -1
    edge = np.zeros((NY, NX), bool)
    edge[3, 0] = True
    d = tmood.dilate4_valid(torch.from_numpy(edge), vt).numpy()
    assert d[3, NX - 1] == per[0]


@pytest.mark.parametrize("per", ((False, False), (True, True)))
def test_plain_check_matches_jax_check_kernel(per):
    """fused_mood_check_plain (stab/mood.check_update) against
    dflo_tpu's make_fused_mood_check in interpret mode, on a candidate near
    the predictor with random degree and limiter maps (every branch of the
    bookkeeping fires)."""
    p = 2
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    rng = np.random.default_rng(2)
    _, u0 = entry._build(NX, NY, device="cpu", method="mood")
    u = u0.numpy() * (1.0 + 1e-6 * rng.standard_normal(u0.shape))
    cand = u0.numpy() * (1.0 + 1e-3 * rng.standard_normal(u0.shape))
    deg = rng.integers(1, p + 1, (NY, NX)).astype(np.int32)
    lim = rng.uniform(size=(NY, NX)) < 0.3
    ops = kernels.mood_check_operators(tb, mesh, per_x=per[0], per_y=per[1],
                                       device="cpu")
    rho0 = torch.from_numpy(ops.avg0 * u[euler.RHO, 0])
    bmin = tmood.neighborhood_min(rho0, ops.valid)
    bmax = tmood.neighborhood_max(rho0, ops.valid)
    degt, limt = interop.planes_from_numpy(deg, lim, "cpu")
    got = kernels.fused_mood_check(torch.from_numpy(cand), bmin, bmax, degt,
                                   limt, ops)
    check = make_fused_mood_check(jb, mesh, per_x=per[0], per_y=per[1],
                                  dtype=jnp.float64)
    cand3 = jnp.asarray(np.stack([cand[euler.RHO, 0], cand[euler.RHO, 2],
                                  cand[euler.RHO, 2 * p + 1]]))
    ref = check(cand3, jnp.asarray(bmin.numpy()), jnp.asarray(bmax.numpy()),
                jnp.asarray(deg), jnp.asarray(lim))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    # the spread, the marks and the reductions all fired
    assert int(got[2].sum()) > 0 and int((got[1] & ~limt).sum()) > 0


@pytest.fixture(scope="module")
def dmr():
    """dflo_tpu's DMR MOOD solver with its jitted mood_stage (compiled
    once), its post_stage'd predictor, and the port's solver."""
    js, u0 = graft._build(NX, NY, method="mood")
    u_pre = np.asarray(jax.jit(js.post_stage)(u0))
    ts, _ = entry._build(NX, NY, device="cpu", method="mood")
    stage = jax.jit(js._mood_stage)
    # compile once, for the argument types every caller passes (f64 arrays)
    stage(jnp.asarray(u_pre), jscalar(0.0), jscalar(1e-4))
    return js, stage, u_pre, ts


def jscalar(x):
    """A float64 JAX scalar (strongly typed, so every call of the jitted
    stage hits one compilation)."""
    return jnp.asarray(x, jnp.float64)


@pytest.mark.parametrize("dt", (1e-4, 4e-4))
def test_one_mood_stage_matches_jax(dmr, dt):
    _, jstage, u_pre, ts = dmr
    cj, lj, sj = jstage(jnp.asarray(u_pre), jscalar(0.0), jscalar(dt))
    u = interop.state_from_numpy(u_pre, F64, "cpu")
    syncs = ts.host_syncs
    ct, lt, st, deg = ts._mood_stage(u, tdt(0.0), tdt(dt))
    assert np.array_equal(np.asarray(lj), lt.numpy())
    assert np.array_equal(interop.stats_as_numpy(sj),
                          interop.stats_as_numpy(st))
    assert st.iters >= 2 and int(st.n_reduce) > 0
    assert ts.host_syncs - syncs == st.iters      # one read per pass
    # the cells where the full-degree chain moves the predictor, named
    mops = ts._mood_stage.mops
    moved = (kernels.fused_modal_pos(u, mops) != u).flatten(0, 1).any(0)
    assert [tuple(c) for c in np.argwhere(moved.numpy())] == [
        (1, 2), (2, 2), (3, 3), (4, 4), (6, 5)]
    near = tmood.dilate4_valid(moved, ts._mood_stage.valid).numpy()
    scale = np.abs(np.asarray(cj)).max()
    err = np.abs(np.asarray(cj) - ct.numpy()).max(axis=(0, 1)) / scale
    assert err[~near].max() <= TOL
    bad = [tuple(c) for c in np.argwhere(err > TOL)]
    assert set(bad) <= {tuple(c) for c in np.argwhere(near)}, bad
    # the sparse cascade is the dense one (sparse_mode="off")
    dense = tmood.make_mood(ts.basis, ts.mesh, ts.rhs, sparse_mode="off")
    cd, ld, sd, degd = dense(u, tdt(0.0), tdt(dt))
    assert rel(cd, ct) <= 1e-12
    assert torch.equal(ld, lt) and torch.equal(degd, deg)
    assert np.array_equal(interop.stats_as_numpy(sd),
                          interop.stats_as_numpy(st))


def test_mood_stage_options():
    ts, u0 = entry._build(16, 8, device="cpu", method="mood")
    stage = ts._mood_stage
    u = ts.post_stage(u0)
    # the warm start (tests/test_torch_mood_options.py holds it against
    # dflo_tpu): a map of ones starts every cell at degree 1, where the
    # cascade can only mark, never reduce
    c1, _, s1, d1 = stage(u, tdt(0.0), tdt(1e-4),
                          deg_in=torch.ones((8, 16), dtype=torch.int32))
    assert torch.equal(d1, torch.ones_like(d1)) and s1.iters == 1
    assert int(s1.n_reduce) == 16 * 8 * (ts.basis.degree - 1)
    # the collapsed bounds fail a superset of the neighborhood's cells
    coll = tmood.make_mood(ts.basis, ts.mesh, ts.rhs,
                           dmp_bounds="collapsed")
    _, _, sn, dn = stage(u, tdt(0.0), tdt(1e-4))
    _, _, sc, dc = coll(u, tdt(0.0), tdt(1e-4))
    assert bool((dc <= dn).all()) and int(sc.n_reduce) >= int(sn.n_reduce)
    with pytest.raises(ValueError, match="dmp_bounds"):
        tmood.make_mood(ts.basis, ts.mesh, ts.rhs, dmp_bounds="nope")
    with pytest.raises(ValueError, match="Pk"):
        tmood.make_mood(make_basis("Qk", 2), ts.mesh, ts.rhs)
    # a dead step (live false) stops after pass 1
    _, _, st, _ = stage(ts.post_stage(u0), tdt(0.0), tdt(1e-3),
                        live=torch.tensor(False))
    assert st.iters == 1


def test_tile_flags():
    cells = torch.zeros((10, 70), dtype=torch.bool)
    cells[0, 0] = cells[9, 69] = cells[5, 33] = True
    flags = kernels.tile_flags(cells, 4, 32)
    assert flags.dtype == torch.uint8 and tuple(flags.shape) == (3, 3)
    assert flags.nonzero().tolist() == [[0, 0], [1, 1], [2, 2]]


# ---------------------------------------------------------------------------
# three steps on a contact discontinuity
# ---------------------------------------------------------------------------

contact = entry.contact_ic


def jax_steps(js, u, n):
    """n steps of dflo_tpu's jitted Solver._step on the CPU:
    [(u, dt, bad, MoodStats as numpy)]."""
    t, out = 0.0, []
    for _ in range(n):
        u, dt, bad, st = js._step(jnp.asarray(u), jscalar(t), jscalar(1.0))
        out.append((np.asarray(u), float(dt), bool(bad),
                    interop.stats_as_numpy(st)))
        t += float(dt)
    return out


def test_three_mood_steps_match_jax(dmr):
    js, _, _, ts = dmr
    from dflo_tpu_torch import ic
    u = ts.post_stage(ic.set_initial_condition(ts.basis, ts.mesh, contact,
                                               dtype=F64, device="cpu"))
    moved = (kernels.fused_modal_pos(u, ts._mood_stage.mops) != u).any()
    assert not bool(moved)                  # no cell at the pressure floor
    ref = jax_steps(js, u.numpy(), 3)
    u1, t1, n, bad, stats = ts._multi_step(3)(u, 0.0, 1.0)
    assert int(n) == 3 and not bool(bad) and not any(r[2] for r in ref)
    assert rel(ref[-1][0], u1) <= TOL
    assert rel(sum(r[1] for r in ref), t1) <= 1e-13
    # the port's chunk sums MoodStats over its steps; last_stats is the
    # last step's, which dflo_tpu's _multi_step returns
    assert np.array_equal(sum(r[3] for r in ref),
                          interop.stats_as_numpy(stats))
    assert np.array_equal(ref[-1][3], interop.stats_as_numpy(ts.last_stats))
    assert int(stats.n_reduce) > 0          # the cascade fired
    # per step, through _step
    v, t = u, 0.0
    for r in ref:
        v, dt, b, st = ts._step(v, t, 1.0)
        t += float(dt)
        assert rel(r[0], v) <= TOL and not bool(b)
        assert np.array_equal(r[3], interop.stats_as_numpy(st))


def test_dmr_mood_steps_match_jax(dmr):
    """Two steps from the DMR predictor: the disagreements of the jitted
    JAX stage at the five pressure-floor cells (test above) stay in columns
    0-9 and move neither dt nor MoodStats."""
    js, _, u_pre, ts = dmr
    ref = jax_steps(js, u_pre, 2)
    v, t = interop.state_from_numpy(u_pre, F64, "cpu"), 0.0
    for k, r in enumerate(ref):
        v, dt, b, st = ts._step(v, t, 1.0)
        t += float(dt)
        assert not bool(b) and not r[2]
        assert abs(float(dt) - r[1]) <= 1e-13 * r[1]
        assert np.array_equal(r[3], interop.stats_as_numpy(st))
        err = (np.abs(r[0] - v.numpy()).max(axis=(0, 1))
               / np.abs(r[0]).max())
        assert err[:, 10:].max() <= TOL, k
    assert err.max() > TOL                  # the floor cells do differ


# ---------------------------------------------------------------------------
# the LxF flux: the candidate and the cascade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ny", (4, 10))
def test_lxf_candidate_plain_matches_jax_candidate(ny):
    """The plain sparse candidate with the LxF flux and every cell set is
    dflo_tpu's dense candidate positivity(truncation(u_pre)) + dt*R_lxf;
    with a cell set the other cells keep u_prev bitwise."""
    from dflo_tpu.solver import spatial as jspatial
    from dflo_tpu.stab import positivity as jpos
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.solver.spatial import make_rhs
    p = 2
    mesh = CartesianMesh(NX, ny, 0.0, 4.0, 0.0, 1.0)
    jb, tb = jax_make_basis("Pk", p), make_basis("Pk", p)
    rng = np.random.default_rng(50 + ny)
    u = ic.set_initial_condition(tb, mesh, entry.dmr_ic, dtype=F64,
                                 device="cpu")
    u = u * torch.from_numpy(1.0 + 0.05 * rng.uniform(-1.0, 1.0, u.shape))
    tbcs = entry._build(NX, ny, device="cpu", method="mood")[0].bcs
    rhs = make_rhs(tb, mesh, tbcs, flux="lxf", dtype=F64, device="cpu",
                   volume_kernel="fused")
    u = kernels.modal_tp_plain(u, None, rhs.modal_ops)
    u_np = u.numpy()
    deg = rng.integers(1, p + 1, (ny, NX)).astype(np.int32)
    t, dt = 0.0, 2e-4
    trunc = np.stack([(jb.mode_degree <= d) for d in range(p + 1)])
    mean = jnp.asarray(float((jb.wq2 @ jb.V)[0]) * u_np[:, 0])
    ut = jax.jit(jpos.make_positivity_limiter(jb, mesh, jnp.float64))(
        jnp.asarray(u_np * np.moveaxis(trunc[deg], -1, 0)[None]), mean)
    jrhs = jax.jit(jspatial.make_rhs(
        jb, mesh, graft._build(NX, ny, method="mood")[0].bcs, flux="lxf",
        dtype=jnp.float64, volume_kernel="xla"))
    ref = np.asarray(ut + dt * jrhs(ut, t))
    degt = torch.from_numpy(deg)
    h = tdt(dt)
    full = rhs.sparse_candidate(u, torch.zeros_like(u), degt, t, h,
                                torch.ones((ny, NX), dtype=torch.bool))
    assert rel(ref, full) <= 1e-12
    cells = torch.from_numpy(rng.uniform(size=(ny, NX)) < 0.3)
    prev = torch.from_numpy(rng.standard_normal(u.shape))
    part = rhs.sparse_candidate(u, prev.clone(), degt, t, h, cells)
    assert torch.equal(part[..., ~cells], prev[..., ~cells])
    assert torch.equal(part[..., cells], full[..., cells])


def test_three_lxf_mood_steps_match_jax():
    """MOOD with the LxF flux (sod_mood's scheme) on the contact
    discontinuity: three steps of the port's Solver against dflo_tpu's
    jitted Solver._step, state within 1e-10, equal MoodStats."""
    from dflo_tpu.driver import LimiterConfig as JLim
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    lim = dict(type="TVB", shock_indicator="density", beta=2.0,
               char_lim=True, pos_lim=True)
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    js = JSolver(jax_make_basis("Pk", 2), mesh,
                 graft._build(NX, NY, method="mood")[0].bcs, flux="lxf",
                 limiter=JLim(**lim), cfl=0.5, dtype=jnp.float64,
                 method="mood")
    ts = Solver(make_basis("Pk", 2), mesh,
                entry._build(NX, NY, device="cpu", method="mood")[0].bcs,
                flux="lxf", limiter=LimiterConfig(**lim), cfl=0.5,
                dtype=F64, device="cpu", method="mood")
    assert ts.rhs.ops.flux == "lxf"
    u = ts.post_stage(ic.set_initial_condition(ts.basis, mesh, contact,
                                               dtype=F64, device="cpu"))
    ref = jax_steps(js, u.numpy(), 3)
    v, t = u, 0.0
    for r in ref:
        v, dt, b, st = ts._step(v, t, 1.0)
        t += float(dt)
        assert abs(float(dt) - r[1]) <= 1e-13 * r[1]
        assert rel(r[0], v) <= TOL and not bool(b) and not r[2]
        assert np.array_equal(r[3], interop.stats_as_numpy(st))
    assert sum(int(r[3][0]) for r in ref) > 0      # the cascade fired


def test_mood_with_gravity_matches_jax():
    """MOOD on P2 with euler.GravitySource(0, -1): the dense cascade on the
    residual's gravity arm, three steps against dflo_tpu's Solver with the
    same body force, state within 1e-10, equal dt and MoodStats."""
    from dflo_tpu.driver import LimiterConfig as JLim
    from dflo_tpu.driver import Solver as JSolver
    from dflo_tpu.physics import euler as jeuler
    from dflo_tpu_torch import ic
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    lim = dict(type="TVB", shock_indicator="density", beta=2.0,
               char_lim=True, pos_lim=True)
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    js = JSolver(jax_make_basis("Pk", 2), mesh,
                 graft._build(NX, NY, method="mood")[0].bcs, flux="hllc",
                 limiter=JLim(**lim), cfl=0.5, dtype=jnp.float64,
                 method="mood",
                 source=lambda x, y, t, W: jeuler.forcing_gravity(
                     W, (0.0, -1.0)))
    ts = Solver(make_basis("Pk", 2), mesh,
                entry._build(NX, NY, device="cpu", method="mood")[0].bcs,
                flux="hllc", limiter=LimiterConfig(**lim), cfl=0.5,
                dtype=F64, device="cpu", method="mood",
                source=euler.GravitySource(0.0, -1.0))
    assert ts.rhs.ops.source == "grav"
    assert not hasattr(ts.rhs, "sparse_candidate")
    assert not ts._mood_stage.sparse
    u = ts.post_stage(ic.set_initial_condition(ts.basis, mesh, contact,
                                               dtype=F64, device="cpu"))
    ref = jax_steps(js, u.numpy(), 3)
    v, t = u, 0.0
    for r in ref:
        v, dt, b, st = ts._step(v, t, 1.0)
        t += float(dt)
        assert abs(float(dt) - r[1]) <= 1e-13 * r[1]
        assert rel(r[0], v) <= TOL and not bool(b) and not r[2]
        assert np.array_equal(r[3], interop.stats_as_numpy(st))
    assert sum(int(r[3][0]) for r in ref) > 0      # the cascade fired
