"""The port's MOOD cascade over its whole degree range against the JAX
package's, in float64 on the CPU (the port's kernels' plain versions).

- Three MOOD steps at p = 1, 4, 5 and 6 from the contact discontinuity of
  tests/test_torch_mood.py (entry.contact_ic) in the DMR box at 32 x 8,
  HLLC, through the port's Solver._step against dflo_tpu's own jitted
  Solver._step: state within 1e-10 relative, equal dt (1e-13) and
  MoodStats, no fatal flag.  On P1 the check is the plain one with the u2
  test off, as the reference's (its basis has no D2 modes; the reference
  builds no check kernel below p = 2, dflo_tpu/stab/mood.py:244-246,
  :284): the cascade marks cells for the limiter and drops no degree.  On
  P4 also the dense route: with a GravitySource (the residual's gravity
  arm) and on a masked box (a solid block; the plain masked check).
- One P4 MOOD stage on the contact: the sparse cascade (the candidate on
  the cells that can change) equals sparse_mode="off" (1e-12), with equal
  degree and limiter maps and MoodStats.
- The over-integrated P2 basis (make_basis("Pk", 2, 4): 4 x 4 Gauss
  points): three MOOD steps against dflo_tpu's Solver on the same basis,
  its sparse candidate laid out for nq = 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.driver import LimiterConfig as JLim
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu_torch import entry, ic, interop
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.stab import mood as tmood

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-10
LIM = dict(type="TVB", shock_indicator="density", beta=2.0, char_lim=True,
           pos_lim=True)


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def solid_block() -> np.ndarray:
    """The fluid flags of the DMR box with a 4 x 2-cell solid block."""
    mask = np.ones((NY, NX), bool)
    mask[2:4, 20:24] = False
    return mask


def solvers(p: int, nq: int | None = None, route: str = "sparse"):
    """dflo_tpu's and the port's MOOD solvers of the DMR box on P_p (nq x
    nq quadrature points, p + 1 unless given), HLLC, and the port's
    post-staged contact state; route "gravity" adds g = (0, -1), "masked"
    the solid block."""
    mesh = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
    jkw, tkw = {}, {}
    if route == "gravity":
        jkw["source"] = lambda x, y, t, W: jeuler.forcing_gravity(
            W, (0.0, -1.0))
        tkw["source"] = euler.GravitySource(0.0, -1.0)
    elif route == "masked":
        jkw["mask"] = tkw["mask"] = solid_block()
    js = JSolver(jax_make_basis("Pk", p, nq), mesh,
                 graft._build(NX, NY, method="mood")[0].bcs, flux="hllc",
                 limiter=JLim(**LIM), cfl=0.5, dtype=jnp.float64,
                 method="mood", **jkw)
    ts = Solver(make_basis("Pk", p, nq), mesh,
                entry._build(NX, NY, device="cpu", method="mood")[0].bcs,
                flux="hllc", limiter=LimiterConfig(**LIM), cfl=0.5,
                dtype=F64, device="cpu", method="mood", **tkw)
    u = ts.post_stage(ts.apply_mask(ic.set_initial_condition(
        ts.basis, mesh, entry.contact_ic, dtype=F64, device="cpu")))
    return js, ts, u


def check_steps(js, ts, u, n: int = 3) -> list:
    """n steps of both solvers from u: per step dt within 1e-13, the state
    within TOL, equal MoodStats, no fatal flag; returns the MoodStats."""
    t_j, t_t, v, out = 0.0, 0.0, u, []
    uj = jnp.asarray(u.numpy())
    for _ in range(n):
        uj, dtj, badj, stj = js._step(uj, jnp.asarray(t_j, jnp.float64),
                                      jnp.asarray(1.0, jnp.float64))
        v, dtt, badt, stt = ts._step(v, t_t, 1.0)
        t_j += float(dtj)
        t_t += float(dtt)
        assert not bool(badj) and not bool(badt)
        assert abs(float(dtt) - float(dtj)) <= 1e-13 * float(dtj)
        assert rel(np.asarray(uj), v) <= TOL
        sj = interop.stats_as_numpy(stj)
        assert np.array_equal(sj, interop.stats_as_numpy(stt))
        out.append(sj)
    return out


@pytest.mark.parametrize("p, route", ((1, "sparse"), (4, "sparse"),
                                      (5, "sparse"), (6, "sparse"),
                                      (4, "gravity"), (4, "masked")))
def test_mood_steps_match_jax(p, route):
    js, ts, u = solvers(p, route=route)
    assert ts.volume_kernel == "fused"
    assert ts._mood_stage.sparse == (route == "sparse")
    # the check: the kernel's operators from p = 2, the plain check on P1
    assert (ts._mood_stage.cops is None) == (p == 1)
    stats = check_steps(js, ts, u)
    n_reduce, n_marked = (sum(int(s[i]) for s in stats) for i in (0, 1))
    if p == 1:
        assert n_reduce == 0 and n_marked > 0    # P1 only marks
    else:
        assert n_reduce > 0                      # the cascade fired


def test_p4_sparse_stage_is_the_dense_one():
    """One P4 MOOD stage: the sparse cascade against sparse_mode="off"."""
    _, ts, u = solvers(4)
    h = torch.tensor(2e-4, dtype=F64)
    t = torch.tensor(0.0, dtype=F64)
    cs, ls, ss, ds = ts._mood_stage(u, t, h)
    dense = tmood.make_mood(ts.basis, ts.mesh, ts.rhs, sparse_mode="off")
    cd, ld, sd, dd = dense(u, t, h)
    assert ss.iters >= 2 and int(ss.n_reduce) > 0
    assert rel(cd, cs) <= 1e-12
    assert torch.equal(ld, ls) and torch.equal(dd, ds)
    assert np.array_equal(interop.stats_as_numpy(sd),
                          interop.stats_as_numpy(ss))


def test_over_integrated_p2_mood_steps_match_jax():
    js, ts, u = solvers(2, 4)
    assert (ts.rhs.ops.p, ts.rhs.ops.nq, ts.rhs.ops.K) == (2, 4, 6)
    assert ts._mood_stage.sparse
    stats = check_steps(js, ts, u)
    assert sum(int(s[0]) for s in stats) > 0
