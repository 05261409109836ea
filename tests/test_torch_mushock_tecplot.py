"""The mu_shock field, the opt-in Laplacian diffusion and the Tecplot
writer against the JAX package, in float64 on the CPU, and the CLI
branches that use them through both CLIs.

- make_mu_shock (dflo_tpu/stab/mushock.py) on the contact discontinuity in
  the Mach-10 flow (1 % seeded noise) on Q2 with the DMR's boundary
  ghosts: inflow, outflow, slip and farfield sides; the same with a
  pressure outlet on E and a segmented S (slip, then a pressure side); and
  on P2 with x periodic.  1e-12 relative, nonnegative (the entropy
  variables' jump product of a convex entropy).  A cell at the pressure
  floor makes its 1/T, so the field there, round-off's: the shocked DMR
  state after positivity has such cells, so the state is the contact.
- make_laplacian_diffusion on the same state and field, 1e-12 relative.
- write_tecplot on a masked Q2 state: the same header and connectivity,
  and every number within the files' print precision (%.10g).
- examples/sod_shock_tube.prm cut to 64 x 10 through both CLIs, 3 steps
  with a snapshot and a checkpoint after each (tests/test_torch_configs.
  check_cli_pair): with `format = tecplot` the .plt snapshots of both
  agree as above; with `diffusion coefficient = 1` every VTU of the port
  carries the mu_shock cell field, equal (1e-10) to dflo_tpu's
  make_mu_shock of dflo_tpu's checkpoint at that snapshot.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu.io import vtk as jvtk
from dflo_tpu.mesh import CartesianMesh as JMesh
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.stab import mushock as jmu
from dflo_tpu_torch import entry, ic
from dflo_tpu_torch.io.vtk import write_tecplot
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.physics import euler as teuler
from dflo_tpu_torch.solver import spatial as tspatial
from dflo_tpu_torch.stab import mushock as tmu

from test_torch_envelope_limiters import (averages, jax_dmr_bcs, jax_pressure,
                                          limited, rel, state, torch_pressure)

NX, NY = 32, 8
F64 = torch.float64
TOL = 1e-12
MESH = CartesianMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)
JMESH = JMesh(NX, NY, 0.0, 4.0, 0.0, 1.0)


def contact_state(family: str, seed: int) -> np.ndarray:
    """The contact discontinuity in the Mach-10 flow (entry.contact_ic)
    with 1 % seeded noise: jumps at the contact and everywhere, and no cell
    near the pressure floor, where the entropy variables' 1/T would make
    the field round-off's."""
    u = ic.set_initial_condition(make_basis(family, 2), MESH,
                                 entry.contact_ic, dtype=F64,
                                 device="cpu").numpy()
    rng = np.random.default_rng(seed)
    return u * (1.0 + 0.01 * rng.uniform(-1.0, 1.0, u.shape))


def side_cases():
    """case -> (family, JAX bcs, port bcs, per_x)."""
    seg = (np.arange(NX) >= NX // 2).astype(np.int32)
    tdmr = entry._build(NX, NY, device="cpu")[0].bcs
    jpres = jspatial.BoundarySide(jeuler.BC_PRESSURE, jax_pressure)
    tpres = tspatial.BoundarySide(teuler.BC_PRESSURE, torch_pressure)
    jseg = jspatial.SegmentedSide(seg, (
        jspatial.BoundarySide(jeuler.BC_SLIP), jpres))
    tseg = tspatial.SegmentedSide(seg, (
        tspatial.BoundarySide(teuler.BC_SLIP), tpres))
    jper = jspatial.BoundarySide(jeuler.BC_PERIODIC)
    tper = tspatial.BoundarySide(teuler.BC_PERIODIC)
    return {
        "dmr": ("Qk", jax_dmr_bcs(), tdmr, False),
        "pressure_segmented": ("Qk", dict(jax_dmr_bcs(jpres), S=jseg),
                               dict(tdmr, E=tpres, S=tseg), False),
        "periodic_x_pk": ("Pk", dict(jax_dmr_bcs(), W=jper, E=jper),
                          dict(tdmr, W=tper, E=tper), True),
    }


@pytest.mark.parametrize("case", ("dmr", "pressure_segmented",
                                  "periodic_x_pk"))
def test_mu_shock_matches_jax(case):
    family, jbcs, tbcs, per_x = side_cases()[case]
    u = contact_state(family, 11)
    ja, ta = averages(family, 2, u)
    ref = np.asarray(jax.jit(jmu.make_mu_shock(
        jax_make_basis(family, 2), JMESH, 1.0, per_x, False,
        dtype=jnp.float64, bcs=jbcs))(jnp.asarray(u), ja, 0.0))
    got = tmu.make_mu_shock(make_basis(family, 2), MESH, 1.0, per_x, False,
                            dtype=F64, device="cpu", bcs=tbcs)(
        torch.from_numpy(u), ta, 0.0)
    assert rel(ref, got) <= TOL
    assert float(got.min()) >= -1e-12 * float(got.max()) > -np.inf
    # without bcs the boundary faces carry no jump; a zero coefficient
    # gives a zero field
    nob = tmu.make_mu_shock(make_basis(family, 2), MESH, 1.0, per_x, False,
                            dtype=F64, device="cpu")(torch.from_numpy(u), ta)
    assert torch.equal(nob[1:-1, 1:-1], got[1:-1, 1:-1])
    zero = tmu.make_mu_shock(make_basis(family, 2), MESH, 0.0, dtype=F64,
                             device="cpu")(torch.from_numpy(u), ta)
    assert not bool(zero.any())


def test_laplacian_diffusion_matches_jax():
    u = contact_state("Qk", 12)
    mu = np.random.default_rng(12).uniform(0.0, 1e-3, (NY, NX))
    ref = jmu.make_laplacian_diffusion(jax_make_basis("Qk", 2), JMESH,
                                       dtype=jnp.float64)(
        jnp.asarray(u), jnp.asarray(mu))
    got = tmu.make_laplacian_diffusion(make_basis("Qk", 2), MESH, dtype=F64,
                                       device="cpu")(
        torch.from_numpy(u), torch.from_numpy(mu))
    assert rel(ref, got) <= TOL


def read_plt(path):
    """(header lines, point rows [n, 7], connectivity [e, 4]) of a .plt."""
    lines = open(path).read().splitlines()
    n = int(re.search(r"N=(\d+)", lines[2]).group(1))
    pts = np.loadtxt(lines[3:3 + n])
    conn = np.loadtxt(lines[3 + n:], dtype=np.int64).reshape(-1, 4)
    return lines[:3], pts, conn


def same_plt(a, b):
    ha, pa, ca = read_plt(a)
    hb, pb, cb = read_plt(b)
    # the zone's time is the packages' sums of dt (equal to 1e-14)
    num = r"(?<==)[0-9.e+-]+(?=[\",]|$)"
    ta = [float(x) for x in re.findall(num, ha[2])]
    tb = [float(x) for x in re.findall(num, hb[2])]
    assert np.allclose(ta, tb, rtol=1e-14, atol=0.0)
    assert ha[:2] == hb[:2] and np.array_equal(ca, cb)
    assert re.sub(num, "", ha[2]) == re.sub(num, "", hb[2])
    # both round to 10 significant digits; a column at round-off level
    # (a tube's y velocity) is held against a millionth of the largest
    mags = np.abs(pa).max(0)
    scale = np.maximum(mags, 1e-6 * mags.max())
    assert (np.abs(pa - pb) / scale).max() <= 1e-9
    return pa


def test_write_tecplot_matches_jax(tmp_path):
    jb, tb = jax_make_basis("Qk", 2), make_basis("Qk", 2)
    u = limited("Qk", 2, state("Qk", 2, "shocked", seed=13))
    mask = np.ones((NY, NX), bool)
    mask[:3, 20:] = False
    jvtk.write_tecplot(str(tmp_path / "j.plt"), jb, JMESH, u, t=0.125,
                       mask=mask)
    write_tecplot(str(tmp_path / "t.plt"), tb, MESH, u, t=0.125, mask=mask)
    pts = same_plt(tmp_path / "j.plt", tmp_path / "t.plt")
    assert len(pts) == 9 * int(mask.sum())


def vtu_cell_field(path, name):
    """A Float64 cell field of the port's appended-binary VTU."""
    data = open(path, "rb").read()
    mark = b'<AppendedData encoding="raw">\n_'
    head = data[:data.index(mark) + len(mark)].decode()
    body = data[len(head):]
    off = int(re.search(rf'Name="{name}" NumberOfComponents="1" '
                        rf'format="appended" offset="(\d+)"', head).group(1))
    n = int(np.frombuffer(body[off:off + 8], np.uint64)[0])
    return np.frombuffer(body[off + 8:off + 8 + n], "<f8")


@pytest.mark.parametrize("branch", ("tecplot", "mu_shock"))
def test_sod_cli_branch_matches_jax(branch, tmp_path):
    from test_torch_configs import check_cli_pair, cut
    text = cut("sod_shock_tube", 64, 10)
    if branch == "tecplot":
        text = text.replace("subsection output",
                            "subsection output\n   set format = tecplot")
    else:
        text = "set diffusion coefficient = 1.0\n" + text
    res, _, _ = check_cli_pair(text, tmp_path, "Pk", 64, steps=3)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    ext = ".plt" if branch == "tecplot" else ".vtu"
    names = sorted(f for f in os.listdir(tout) if f.endswith(ext))
    assert len(names) == 5                   # IC, three steps, final
    if branch == "tecplot":
        assert not [f for f in os.listdir(tout) if f.endswith(".vtu")]
        for f in names:
            same_plt(jout / f, tout / f)
        return
    s = res.solver
    jb = jax_make_basis("Pk", 2)
    jm = JMesh(64, 10, s.mesh.x0, s.mesh.x1, s.mesh.y0, s.mesh.y1)
    from dflo_tpu import cli as jcli
    from dflo_tpu.config.params import AllParameters as JParams
    jp = JParams.from_prm_file(str(tmp_path / "config.prm"))
    jbcs = jcli.build_bcs(jp, {"W": np.full(10, 4), "E": np.full(10, 2),
                               "S": np.full(64, 1), "N": np.full(64, 3)})
    mu = jax.jit(jmu.make_mu_shock(jb, jm, 1.0, bcs=jbcs))
    for i, f in enumerate(names):
        with np.load(jout / f"checkpoint-{i:03d}.npz") as z:
            ju, t = jnp.asarray(z["u"]), float(z["t"])
        ref = np.asarray(mu(ju, jspatial.cell_averages(jb, ju), t))
        got = vtu_cell_field(tout / f, "mu_shock")
        want = np.repeat(ref.ravel(), 4)     # a P2 cell's 2 x 2 subcells
        assert rel(want, got) <= 1e-10, f
        assert float(got.max()) > 0.0
