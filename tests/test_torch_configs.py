"""The seven Cartesian configs through the port's CLI against the JAX
package's CLI, on the CPU in float64.

examples/sod_shock_tube.prm (P2, hllc, rk3, TVB), sod_mood.prm (P2, lxf,
MOOD, TVB and positivity), isentropic_vortex.prm (P2, lxf, rk3, limiter
`none`, periodic on all four sides), vortex_system.prm (P1, lxf, rk3, TVB)
and vortex_system_pbc.prm (Q1, lxf, rk3, TVB, periodic on all four sides)
are cut to 64 cells along x with their shipped ny (the tubes) or to 16 x 16
(the vortices); rayleigh_taylor.prm (Q1, hllc, rk3, characteristic TVB,
gravity 1, slip walls) to 16 x 48 and iso_xing_shu.prm (GLL2, hllc, rk3,
limiter `none`, isothermal well-balanced gravity on the potential x + y,
outflow sides) to 16 x 16; each with a snapshot and a checkpoint after every
step, and run 5 steps through `python -m dflo_tpu ... --platform cpu --x64`
(the JAX package's XLA path) and the port's `cli.run([..., "--platform",
"cpu", "--x64"])` (every kernel wrapper's plain version). Every checkpoint
must agree to 1e-10 relative per component (the packages differ by summation
orders; five steps keep that near round-off), with equal times to 1e-14 and
equal step and snapshot counts. A component whose largest magnitude is below
a millionth of the state's (the tubes' y momentum, which the slip walls keep
at round-off, 1e-16) is measured against that millionth instead, so its
round-off differences are held to about 1e-16 absolute.

iso_xing_shu's state is the hydrostatic equilibrium, at rest: its momentum
is the well-balanced scheme's round-off in either package (up to 7e-16
after 5 steps), and any two summation orders leave different round-off
there (the port's plain and fused forms differ from each other by 4e-16,
each from the JAX package by 6e-16).  So its checkpoints are held to 1e-10
relative to the state's largest magnitude, and the port's momentum itself
to the well-balance oracle of tests/test_gravity.py, below 5e-13.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from dflo_tpu import cli as jcli
from dflo_tpu_torch import cli

TOL = 1e-10
STEPS = 5
#: the configs whose state is at rest (their momentum is round-off)
AT_REST = {"iso_xing_shu"}
#: config -> (nx, ny) of the cut copy, and the family it runs
CONFIGS = {"sod_shock_tube": ((64, 10), "Pk"), "sod_mood": ((64, 4), "Pk"),
           "isentropic_vortex": ((16, 16), "Pk"),
           "vortex_system": ((16, 16), "Pk"),
           "vortex_system_pbc": ((16, 16), "Qk"),
           "rayleigh_taylor": ((16, 48), "Qk"),
           "iso_xing_shu": ((16, 16), "Qk_gll")}


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|, a component's scale at
    least a millionth of the state's largest magnitude (a zero state must
    agree exactly)."""
    mags = np.abs(a).reshape(4, -1).max(1)
    scale = np.maximum(mags, max(1e-6 * mags.max(), 1e-300))
    return float((np.abs(a - b).reshape(4, -1).max(1) / scale).max())


def ckpt(d, i):
    with np.load(os.path.join(d, f"checkpoint-{i:03d}.npz")) as z:
        return {k: z[k] for k in z.files}


def cut(name: str, nx: int, ny: int) -> str:
    """The shipped config with nx, ny and an output every step."""
    src = open(f"examples/{name}.prm").read()
    src = re.sub(r"set nx = \d+", f"set nx = {nx}", src)
    src = re.sub(r"set ny = \d+", f"set ny = {ny}", src)
    if "iter step" in src:
        return re.sub(r"set iter step = \d+", "set iter step = 1", src)
    return src + "\nsubsection output\n   set iter step = 1\nend\n"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name, tmp_path):
    (nx, ny), family = CONFIGS[name]
    prm = tmp_path / f"{name}.prm"
    prm.write_text(cut(name, nx, ny))
    common = [str(prm), "--platform", "cpu", "--x64", "--max-steps",
              str(STEPS), "--checkpoint-every", "1"]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jlog = io.StringIO()
    with contextlib.redirect_stdout(jlog):
        assert jcli.main(common + ["--output-dir", str(jout)]) == 0
        res = cli.run(common + ["--output-dir", str(tout)])
    assert re.search(rf"steps={STEPS}\s", jlog.getvalue())
    assert res.it == STEPS
    names = sorted(f for f in os.listdir(jout) if f.startswith("checkpoint"))
    assert names == sorted(f for f in os.listdir(tout)
                           if f.startswith("checkpoint"))
    assert len(names) == STEPS + 2          # IC, one per step, final
    for i in range(len(names)):
        a, b = ckpt(jout, i), ckpt(tout, i)
        assert int(a["it"]) == int(b["it"]) == i
        assert abs(float(a["t"]) - float(b["t"])) <= 1e-14 * max(
            float(a["t"]), 1e-300)
        if name in AT_REST:
            err = float(np.abs(a["u"] - b["u"]).max() / np.abs(a["u"]).max())
            assert err <= TOL, (name, i, err)
            assert np.abs(b["u"][:2]).max() < 5e-13, (name, i)
        else:
            assert rel(a["u"], b["u"]) <= TOL, (name, i, rel(a["u"], b["u"]))
        assert str(b["family"]) == family and int(b["nx"]) == nx
    assert np.isfinite(res.u.numpy()).all()
