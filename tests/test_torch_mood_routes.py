"""MOOD off the fused route against the JAX package's Solver, in float64
on the CPU: three steps each on the contact discontinuity in the Mach-10
flow (entry.contact_ic, where the cascade fires and no cell sits at the
pressure floor), 32 x 8, P2, hllc, against three calls of dflo_tpu's
jitted Solver._step with the same configuration:

- ``volume_kernel="xla"``: the plain residual, MoodStage's plain arm
  (truncation, the plain positivity about the predictor's averages, the
  plain check), the plain modal TVB on the marked cells and the plain
  positivity, the diag for dt (dflo_tpu/driver.py:283-330, :457-466);
- a source callable the residual kernel does not carry (a gravity lambda):
  "auto" resolves to the plain residual, as the reference's vol_ok;
- positivity off: the fused residual's forward-Euler form, the plain arm
  without positivity, no Pk post;
- limiter ``none`` (positivity on): the fused route's cascade, the modal
  positivity kernel's plain version as the stage's post;
- TVB with the angular-momentum option: the fused cascade, the plain TVB
  (no fused Pk post: it has no angular-momentum term), the modal
  positivity.

State within 1e-10 relative, equal dt (1e-13), equal MoodStats every
step, no fatal flag; the cascade fires.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dflo_tpu.driver import LimiterConfig as JLim
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.physics import euler as jeuler
from dflo_tpu_torch import entry, ic, interop
from dflo_tpu_torch.driver import LimiterConfig
from dflo_tpu_torch.physics import euler as teuler

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-10
TVB = dict(type="TVB", shock_indicator="density", beta=2.0, char_lim=True,
           pos_lim=True)
#: case -> (limiter, JAX Solver keywords, port Solver keywords, the port's
#: expected (volume form, fused cascade, fused Pk post))
CASES = {
    "xla": (TVB, {}, {"volume_kernel": "xla"}, ("xla", False, False)),
    "source": (TVB, {"source": lambda x, y, t, W: jeuler.forcing_gravity(
        W, (0.0, -1.0))}, {"source": lambda x, y, t, W:
                           teuler.forcing_gravity(W, (0.0, -1.0))},
               ("xla", False, False)),
    "no_positivity": (dict(TVB, pos_lim=False), {}, {},
                      ("fused", False, False)),
    "limiter_none": (dict(TVB, type="none"), {}, {}, ("fused", True, False)),
    "angular_momentum": (dict(TVB, conserve_angular_momentum=True), {}, {},
                         ("fused", True, False)),
}


def rel(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


#: the cases of this file; the fused cascade's two post routes run in
#: tests/test_torch_mood_options.py (the files stay near a minute each)
OFF_ROUTE = ("xla", "source", "no_positivity")


@pytest.mark.parametrize("case", OFF_ROUTE)
def test_mood_route_steps_match_jax(case):
    check_case(case)


def check_case(case: str) -> None:
    """Three steps of CASES[case] in both packages (see the docstring)."""
    lim, jkw, tkw, (form, fused, pk_post) = CASES[case]
    jbase, _ = graft._build(NX, NY, method="mood")
    js = JSolver(jbase.basis, jbase.mesh, jbase.bcs, flux="hllc",
                 limiter=JLim(**lim), cfl=0.5, dtype=jnp.float64,
                 method="mood", **jkw)
    ts, _ = entry._build(NX, NY, dtype=F64, device="cpu", method="mood",
                         limiter=LimiterConfig(**lim), **tkw)
    assert ts.volume_kernel == form
    assert ts._mood_stage.fused == fused
    assert (ts._pk_post_ops is not None) == pk_post
    u = ts.post_stage(ic.set_initial_condition(
        ts.basis, ts.mesh, entry.contact_ic, dtype=F64, device="cpu"))
    ju, v, t, fired = jnp.asarray(u.numpy()), u, 0.0, 0
    for k in range(3):
        ju, jdt, jbad, jst = js._step(ju, jnp.asarray(t), jnp.asarray(1.0))
        v, dt, bad, st = ts._step(v, t, 1.0)
        t += float(jdt)
        assert abs(float(dt) - float(jdt)) <= 1e-13 * float(jdt), k
        assert rel(ju, v) <= TOL, k
        assert not bool(bad) and not bool(jbad)
        assert np.array_equal(interop.stats_as_numpy(jst),
                              interop.stats_as_numpy(st)), k
        fired += int(st.n_reduce)
    assert fired > 0
