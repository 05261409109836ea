"""The physics envelope's CLI branches through both CLIs, on the CPU in
float64 (tests/test_torch_configs.check_cli_pair: a snapshot and a
checkpoint after every step, equal step counts and times, every checkpoint
within 1e-10 relative per component):

- iso_xing_shu.prm with `mass matrix = full` at 16 x 16 (GLL2, the plain
  residual with the consistent mass, isothermal well-balanced gravity) and
  cfl 0.5: at rest, so held to the state's scale with the port's momentum
  below the well-balance oracle of tests/test_gravity.py (5e-13).  At the
  shipped cfl 0.9 the consistent mass is unstable in both packages: the
  rest state's round-off grows several-fold a step (ten-fold at 32 x 32;
  test_full_mass_at_the_shipped_cfl_grows_in_both_packages);
- forward_step_tpu.prm at 48 x 16 with its outlet (boundary_2) a pressure
  side at the free stream's pressure (the energy slot, 1.0);
- vortex_system.prm at 16 x 16 with `conserve angular momentum = true`
  (P1, TVB with every cell marked): both CLIs print the same angular-
  momentum monitor lines (to 1e-10);
- sod_shock_tube.prm at 64 x 10 with the u2 shock indicator (P2).
"""

import re

import jax
import numpy as np
import pytest
import torch

from dflo_tpu import cli as jcli
from dflo_tpu.config.params import AllParameters as JParams
from dflo_tpu_torch import cli
from dflo_tpu_torch.config.params import AllParameters
from dflo_tpu_torch.physics import euler as teuler

from test_torch_configs import check_cli_pair, cut

STEPS = 4
#: name -> (config, (nx, ny), family, its edits, at rest)
BRANCHES = {
    "iso_full_mass": ("iso_xing_shu", (16, 16), "Qk_gll", (
        ("set potential = x + y",
         "set potential = x + y\nset mass matrix = full"),
        ("set cfl = 0.9", "set cfl = 0.5")), True),
    "fwd_pressure_outlet": ("forward_step_tpu", (48, 16), "Qk", (
        ("subsection boundary_2\n   set type = outflow",
         "subsection boundary_2\n   set type = pressure\n"
         "   set w_3 value = 1.0"),), False),
    "vortex_angular_momentum": ("vortex_system", (16, 16), "Pk", (
        ("set beta = 2",
         "set beta = 2\n   set conserve angular momentum = true"),), False),
    "sod_u2": ("sod_shock_tube", (64, 10), "Pk", (
        ("set shock indicator = limiter", "set shock indicator = u2"),),
        False),
}


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_envelope_cli_branch_matches_jax(name, tmp_path):
    config, (nx, ny), family, edits, at_rest = BRANCHES[name]
    text = cut(config, nx, ny)
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    logs = {}
    res, _, _ = check_cli_pair(text, tmp_path, family, nx, at_rest=at_rest,
                               steps=STEPS, logs=logs)
    s = res.solver
    lim = s.limiter_cfg
    if name == "iso_full_mass":
        assert s.volume_kernel == "xla"
    elif name == "fwd_pressure_outlet":
        assert s.bcs["E"].kind == teuler.BC_PRESSURE
        assert s.volume_kernel == "fused"
    elif name == "vortex_angular_momentum":
        assert lim.conserve_angular_momentum and not s._fused_chain
        pat = r"Total angular momentum:\s+(\S+)\s+(\S+)"
        jl, tl = (np.array(re.findall(pat, logs[k]), float)
                  for k in ("jax", "port"))
        assert jl.shape == tl.shape == (STEPS, 2)
        assert np.allclose(jl, tl, rtol=1e-10, atol=1e-12)
    else:
        assert lim.shock_indicator == "u2"


def test_full_mass_at_the_shipped_cfl_grows_in_both_packages(tmp_path):
    """iso_xing_shu with the full mass matrix at its shipped cfl 0.9, f64,
    16 x 16: the momentum of the rest state, round-off at first, grows
    several-fold a step in the port and in dflo_tpu alike (over 1,000-fold
    in 8 steps), the two within a factor 10 of each other; at cfl 0.5 it
    stays at round-off."""
    growth = {}
    for cfl in ("0.9", "0.5"):
        prm = tmp_path / f"iso_{cfl}.prm"
        prm.write_text(cut("iso_xing_shu", 16, 16).replace(
            "set potential = x + y",
            "set potential = x + y\nset mass matrix = full").replace(
            "set cfl = 0.9", f"set cfl = {cfl}"))
        p = AllParameters.from_prm_file(str(prm))
        s, _ = cli.build_solver(p, dtype=torch.float64, device="cpu")
        u, t, growth[cfl] = s.post_stage(cli.set_ic(p, s)), 0.0, []
        for _ in range(8):
            u, dt, _, _ = s._step(u, t, 1e3)
            t += float(dt)
            growth[cfl].append(float(u[:2].abs().max()))
    jp = JParams.from_prm_file(str(tmp_path / "iso_0.9.prm"))
    js, _ = jcli.build_solver(jp, str(tmp_path))
    ju, jt = jax.jit(js.post_stage)(jcli.set_ic(jp, js)), 0.0
    for _ in range(8):
        ju, jdt, _, _ = js._step(ju, jt, 1e3)
        jt += float(jdt)
    jmom = float(np.abs(np.asarray(ju)[:2]).max())
    first, last = growth["0.9"][0], growth["0.9"][-1]
    assert last > 1e3 * first and jmom > 1e3 * first
    assert 0.1 < jmom / last < 10.0
    assert max(growth["0.5"]) < 1e-13
