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

Two edited configs run the MOOD cascade's newer routes the same way:
forward_step_tpu.prm on P2 (`basis = Pk`, `degree = 2`, `method = mood`:
masked MOOD, the dense route with the plain masked check) cut to 48 x 16,
and sod_mood.prm with `flux = roe` (the Roe candidate) cut to 48 x 4, the
tube's own four rows (its y momentum is round-off, and more rows grow it
past the millionth floor above: 16 rows differ by 5e-16, 2e-10 of the
floor), 8 steps (its cascade first fires in step 7); with `output =
verbose` both CLIs print every step's MoodStats, which must be equal, and
the cascade fires.

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


def edited(name: str, nx: int, ny: int, *edits) -> str:
    """cut(name, nx, ny) with each (old, new) replaced and the linear
    solver's output verbose (every step's MoodStats printed)."""
    src = cut(name, nx, ny)
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    return src.replace("subsection linear solver",
                       "subsection linear solver\n   set output = verbose")


def check_cli_pair(text: str, tmp_path, family: str, nx: int,
                   at_rest: bool = False, steps: int = STEPS,
                   equal_moods: bool = True, logs: dict | None = None):
    """The config `text` through both CLIs, `steps` steps with a checkpoint
    after each: equal step counts and times, every checkpoint within TOL
    (rel, or for a state at rest relative to its largest magnitude with
    the port's momentum below 5e-13), and (equal_moods) the MOOD counters
    of every step the two print equal.  Returns (the port's CliRun, the
    JAX package's counters, the port's); logs, when given, receives the
    two CLIs' standard output under "jax" and "port"."""
    prm = tmp_path / "config.prm"
    prm.write_text(text)
    common = [str(prm), "--platform", "cpu", "--x64", "--max-steps",
              str(steps), "--checkpoint-every", "1"]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jlog, tlog = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jlog):
        assert jcli.main(common + ["--output-dir", str(jout)]) == 0
    with contextlib.redirect_stdout(tlog):
        res = cli.run(common + ["--output-dir", str(tout)])
    if logs is not None:
        logs.update(jax=jlog.getvalue(), port=tlog.getvalue())
    assert re.search(rf"steps={steps}\s", jlog.getvalue())
    pat = r"it=\s*(\d+).*mood: (reduce=\d+ limit=\d+ passes=\d+)"
    moods = re.findall(pat, jlog.getvalue())
    tmoods = re.findall(pat, tlog.getvalue())
    assert moods == tmoods or not equal_moods
    assert res.it == steps
    names = sorted(f for f in os.listdir(jout) if f.startswith("checkpoint"))
    assert names == sorted(f for f in os.listdir(tout)
                           if f.startswith("checkpoint"))
    assert len(names) == steps + 2          # IC, one per step, final
    for i in range(len(names)):
        a, b = ckpt(jout, i), ckpt(tout, i)
        assert int(a["it"]) == int(b["it"]) == i
        assert abs(float(a["t"]) - float(b["t"])) <= 1e-14 * max(
            float(a["t"]), 1e-300)
        if at_rest:
            err = float(np.abs(a["u"] - b["u"]).max() / np.abs(a["u"]).max())
            assert err <= TOL, (i, err)
            assert np.abs(b["u"][:2]).max() < 5e-13, i
        else:
            assert rel(a["u"], b["u"]) <= TOL, (i, rel(a["u"], b["u"]))
        assert str(b["family"]) == family and int(b["nx"]) == nx
    assert np.isfinite(res.u.numpy()).all()
    return res, moods, tmoods


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name, tmp_path):
    (nx, ny), family = CONFIGS[name]
    check_cli_pair(cut(name, nx, ny), tmp_path, family, nx,
                   at_rest=name in AT_REST)


#: the edited MOOD configs: name -> (config, (nx, ny), steps, its edits)
MOOD_EDITS = {
    "forward_step_p2_mood": ("forward_step_tpu", (48, 16), STEPS, (
        ("set degree = 1", "set degree = 2\nset basis = Pk"),
        ("set method = rk3", "set method = mood"))),
    "sod_mood_roe": ("sod_mood", (48, 4), 8,
                     (("set flux = lxf", "set flux = roe"),)),
}


@pytest.mark.parametrize("name", sorted(MOOD_EDITS))
def test_edited_mood_config_matches_jax(name, tmp_path):
    config, (nx, ny), steps, edits = MOOD_EDITS[name]
    res, moods, _ = check_cli_pair(edited(config, nx, ny, *edits),
                                   tmp_path, "Pk", nx, steps=steps)
    assert res.solver.method == "mood"
    assert len(moods) == steps and sum(
        int(m[1].split()[0].split("=")[1]) for m in moods) > 0
