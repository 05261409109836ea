"""The port's curvilinear blocks (`mapping = q1`) against the JAX package's,
in float64 on the CPU.

- make_rhs_curvilinear against dflo_tpu's on wavy_mesh(10, 8) (farfield,
  outflow, a segmented slip/farfield bottom and a farfield top) and on an
  8 x 64 annulus (periodic wrap, slip inside, farfield outside), with hllc,
  roe and lxf at Q1-Q3, on a seeded perturbed state: within 1e-12 of the
  largest magnitude per component; the metric-weighted cell averages and
  compute_dt_curvilinear too.
- The free stream on a distorted wavy mesh stays below 1e-12, and on an
  undistorted grid the curvilinear residual is the Cartesian one
  (tests/test_curvilinear.py:32-63).
- 5 RK3 steps of the annulus slip-wall rotation (tests/test_curvilinear.py:
  95) through the port's Solver against dflo_tpu's jitted Solver._step,
  with positivity on: each dt and the state within 1e-10.
- Output: write_vtu on a q1 block (the native writer and the plain one)
  holds the reference's points and schlieren field (dflo_tpu/io/vtk.py
  _physical_gradient) within 1e-12.
- The refusals of a curvilinear block (TVB, masks, the kernels' forms,
  minmax naming slice E, a device mesh).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu import ic as jic
from dflo_tpu.driver import LimiterConfig as JLim
from dflo_tpu.driver import Solver as JSolver
from dflo_tpu.io import vtk as jvtk
from dflo_tpu.mesh import curvilinear as jcurvi
from dflo_tpu.ops.basis import make_basis as jax_make_basis
from dflo_tpu.physics import euler as jeuler
from dflo_tpu.solver import spatial as jspatial
from dflo_tpu.solver import spatial_curvi as jsc
from dflo_tpu_torch import ic, interop
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.io.vtk import write_vtu
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.mesh.curvilinear import (CurvilinearMesh, annulus_mesh,
                                             wavy_mesh)
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel import device_mesh
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver import spatial as tspatial
from dflo_tpu_torch.solver import spatial_curvi
from dflo_tpu_torch.solver.spatial import (BoundarySide, SegmentedSide,
                                           make_rhs)

F64 = torch.float64
FAR = (0.5, 0.1, 1.0, 2.6)


def rel(a, b) -> float:
    """max over components of max|a - b| / max|a|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a).reshape(a.shape[0], -1).max(1), 1e-300)
    return float((np.abs(a - b).reshape(a.shape[0], -1).max(1)
                  / scale).max())


def far_t(x, y, t):
    return torch.stack([torch.full_like(x, v) for v in FAR])


def far_j(x, y, t):
    return jnp.stack([jnp.full_like(x, v) for v in FAR])


def sides(mod, kinds, far):
    """The four sides of a case in either package; a (kind, kind) pair is a
    bottom split at the middle (a SegmentedSide)."""
    def one(kind):
        return mod.BoundarySide(kind, far if kind in (0, 4) else None)
    out = {}
    for name, kind in kinds.items():
        if isinstance(kind, tuple):
            n = 10
            out[name] = mod.SegmentedSide(
                (np.arange(n) >= n // 2).astype(np.int32),
                tuple(one(k) for k in kind))
        else:
            out[name] = one(kind)
    return out


MESHES = {
    "wavy": (lambda m: m.wavy_mesh(10, 8, 0.0, 2.0, 0.0, 1.0, amp=0.08),
             dict(W=jeuler.BC_FARFIELD, E=jeuler.BC_OUTFLOW,
                  S=(jeuler.BC_SLIP, jeuler.BC_FARFIELD),
                  N=jeuler.BC_FARFIELD)),
    "annulus": (lambda m: m.annulus_mesh(0.5, 1.0, 8, 64),
                dict(W=jeuler.BC_PERIODIC, E=jeuler.BC_PERIODIC,
                     S=jeuler.BC_SLIP, N=jeuler.BC_FARFIELD)),
}


def perturbed(shape, seed):
    rng = np.random.default_rng(seed)
    return (np.array(FAR)[:, None, None, None]
            * (1.0 + 0.05 * rng.standard_normal(shape)))


@pytest.mark.parametrize("p", (1, 2, 3))
@pytest.mark.parametrize("flux", ("hllc", "roe", "lxf"))
@pytest.mark.parametrize("case", tuple(MESHES))
def test_curvilinear_rhs_matches_jax(case, flux, p):
    build, kinds = MESHES[case]
    jm = build(jcurvi)
    tm = interop.mesh_from_numpy(jm)
    jb = jax_make_basis("Qk", p)
    tb = interop.operators_from_numpy(jb)
    u = perturbed((4, jb.K, jm.ny, jm.nx), 10 * p + len(flux))
    jr = jsc.make_rhs_curvilinear(jb, jm, sides(jspatial, kinds, far_j),
                                  flux=flux, dtype=jnp.float64)
    jrhs = jax.jit(jr)
    tr = spatial_curvi.make_rhs_curvilinear(
        tb, tm, sides(tspatial, kinds, far_t), flux=flux, dtype=F64,
        device="cpu")
    ut = torch.from_numpy(u)
    assert rel(jrhs(jnp.asarray(u), 0.3), tr(ut, 0.3)) <= 1e-12
    jbar = jr.cell_averages(jnp.asarray(u))
    tbar = tr.cell_averages(ut)
    assert rel(jbar, tbar) <= 1e-14
    jdt = float(jsc.compute_dt_curvilinear(jbar, jm, p, 0.4))
    tdt = float(spatial_curvi.compute_dt_curvilinear(tbar, tm, p, 0.4))
    assert abs(jdt - tdt) <= 1e-14 * jdt


@pytest.mark.parametrize("p", (1, 2, 3))
@pytest.mark.parametrize("flux", ("lxf", "hllc", "roe"))
def test_free_stream_on_wavy_mesh(p, flux):
    basis = make_basis("Qk", p)
    mesh = wavy_mesh(10, 8, 0.0, 2.0, 0.0, 1.0, amp=0.08)
    out = BoundarySide(euler.BC_OUTFLOW)
    rhs = spatial_curvi.make_rhs_curvilinear(
        basis, mesh, dict(W=out, E=out, S=out, N=out), flux=flux,
        dtype=F64, device="cpu")

    def const(x, y, t=0.0):
        return torch.stack([torch.full_like(x, v)
                            for v in (0.3, -0.2, 1.1, 3.0)])

    u = ic.set_initial_condition(basis, mesh, const, dtype=F64, device="cpu")
    assert float(rhs(u, 0.0).abs().max()) < 1e-12


def test_matches_cartesian_limit():
    basis = make_basis("Qk", 2)
    cart = CartesianMesh(12, 8, 0.0, 3.0, 0.0, 2.0)
    XX, YY = np.meshgrid(np.linspace(0.0, 3.0, 13), np.linspace(0.0, 2.0, 9))
    per = BoundarySide(euler.BC_PERIODIC)
    bcs = dict(W=per, E=per, S=per, N=per)
    u = ic.set_initial_condition(basis, cart,
                                 ic.isentropic_vortex(5.0, 1.5, 1.0),
                                 dtype=F64, device="cpu")
    r1 = make_rhs(basis, cart, bcs, flux="hllc", dtype=F64, device="cpu")
    r2 = spatial_curvi.make_rhs_curvilinear(
        basis, CurvilinearMesh(XX, YY), bcs, flux="hllc", dtype=F64,
        device="cpu")
    np.testing.assert_allclose(r2(u, 0.0), r1(u, 0.0), rtol=1e-10,
                               atol=1e-10)


def rotating(mod):
    """Solid-body rotation omega = 1 with p from the radial balance
    (tests/test_curvilinear.py:104-110) in jnp or torch."""
    def fn(x, y, t=0.0):
        r2 = x * x + y * y
        rho = mod.ones_like(x)
        p = 1.0 + 0.5 * r2
        return mod.stack([-y * rho, x * rho, rho,
                          p / (euler.GAMMA - 1.0) + 0.5 * rho * r2])
    return fn


def test_annulus_rotation_steps_match_jax():
    """5 RK3 steps of the annulus slip-wall rotation (Q2, hllc, positivity
    on, limiter none) through both Solvers from the same state."""
    jm = jcurvi.annulus_mesh(0.5, 1.0, 8, 64)
    jb = jax_make_basis("Qk", 2)
    jper = jspatial.BoundarySide(jeuler.BC_PERIODIC)
    jslip = jspatial.BoundarySide(jeuler.BC_SLIP)
    js = JSolver(jb, jm, dict(W=jper, E=jper, S=jslip, N=jslip),
                 flux="hllc", limiter=JLim(pos_lim=True), cfl=0.4,
                 dtype=jnp.float64)
    per, slip = BoundarySide(euler.BC_PERIODIC), BoundarySide(euler.BC_SLIP)
    ts = Solver(interop.operators_from_numpy(jb),
                interop.mesh_from_numpy(jm),
                dict(W=per, E=per, S=slip, N=slip), flux="hllc",
                limiter=LimiterConfig(pos_lim=True), cfl=0.4, dtype=F64,
                device="cpu")
    assert ts.curvilinear and ts.volume_kernel == ts.post_kernel == "xla"
    u0 = np.asarray(jic.set_initial_condition(jb, jm, rotating(jnp)))
    uj, ut, t = jnp.asarray(u0), torch.from_numpy(u0.copy()), 0.0
    for _ in range(5):
        uj, dtj, badj, _ = js._step(uj, t, 1.0)
        ut, dtt, badt, _ = ts._step(ut, t, 1.0)
        assert abs(float(dtj) - float(dtt)) <= 1e-13 * float(dtj)
        assert not bool(badj) and not bool(badt)
        t += float(dtj)
    assert rel(uj, ut) <= 1e-10
    # the chunked loop (no carried wave speed on a curvilinear block)
    uc, tc, n, bad, _ = ts._multi_step(5)(torch.from_numpy(u0.copy()), 0.0,
                                          1.0)
    assert int(n) == 5 and not bool(bad)
    assert rel(ut, uc) <= 1e-13


def vtu_arrays(path):
    """name -> array of an appended-raw VTU file."""
    data = open(path, "rb").read()
    mark = b'<AppendedData encoding="raw">\n_'
    head = data[:data.index(mark) + len(mark)].decode()
    body = data[len(head):]
    out = {}
    for m in re.finditer(r'type="(\w+)" Name="(\w+)" NumberOfComponents='
                         r'"(\d)" format="appended" offset="(\d+)"', head):
        kind, name, _, off = m.groups()
        off = int(off)
        n = int(np.frombuffer(body[off:off + 8], np.uint64)[0])
        dt = {"Float64": "<f8", "Int32": "<i4", "UInt8": "u1"}[kind]
        out[name] = np.frombuffer(body[off + 8:off + 8 + n], dt)
    return out


@pytest.mark.parametrize("writer", ("native", "python"))
def test_write_vtu_on_a_q1_block_matches_jax(tmp_path, writer):
    jm = jcurvi.wavy_mesh(10, 8, 0.0, 2.0, 0.0, 1.0, amp=0.08)
    jb = jax_make_basis("Qk", 2)
    u = perturbed((4, jb.K, 8, 10), 7)
    path = str(tmp_path / f"q1_{writer}.vtu")
    write_vtu(path, interop.operators_from_numpy(jb),
              interop.mesh_from_numpy(jm), u, t=0.25, writer=writer)
    got = vtu_arrays(path)
    nodes = jvtk._patch_nodes(2)
    xn, yn = jm.point_coords(nodes)
    drdx, drdy = jvtk._physical_gradient(jb, jm, u[jeuler.RHO], nodes)

    def flat(f):
        return np.asarray(f).reshape(len(nodes), -1).T.ravel()

    pts = got["Points"].reshape(-1, 3)
    assert rel(flat(xn)[None], pts[:, 0][None]) <= 1e-12
    assert rel(flat(yn)[None], pts[:, 1][None]) <= 1e-12
    assert rel(flat(drdx**2 + drdy**2)[None],
               got["schlieren_plot"][None]) <= 1e-12


def test_curvilinear_refusals():
    mesh = annulus_mesh(0.5, 1.0, 4, 16)
    per, slip = BoundarySide(euler.BC_PERIODIC), BoundarySide(euler.BC_SLIP)
    bcs = dict(W=per, E=per, S=slip, N=slip)
    basis = make_basis("Qk", 1)
    kw = dict(dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="TVB limiter requires"):
        Solver(basis, mesh, bcs, limiter=LimiterConfig(type="TVB"), **kw)
    with pytest.raises(ValueError, match="Cartesian-path"):
        Solver(basis, mesh, bcs, mask=np.ones((4, 16), bool), **kw)
    with pytest.raises(NotImplementedError, match="slice E"):
        Solver(basis, mesh, bcs, limiter=LimiterConfig(type="minmax"), **kw)
    for form in (dict(volume_kernel="fused"), dict(post_kernel="fused"),
                 dict(volume_kernel="pallas")):
        with pytest.raises(ValueError, match="no kernel form"):
            Solver(basis, mesh, bcs, **form, **kw)
    with pytest.raises(NotImplementedError, match="slice G"):
        Solver(basis, mesh, bcs, device_mesh=device_mesh(
            (1, 2), [torch.device("cpu")] * 2), **kw)
    with pytest.raises(ValueError, match="collocated Qk"):
        spatial_curvi.make_rhs_curvilinear(make_basis("Pk", 1), mesh, bcs,
                                           **kw)
    inverted = CurvilinearMesh(mesh.X[:, ::-1].copy(), mesh.Y[:, ::-1].copy())
    with pytest.raises(ValueError, match="detJ <= 0"):
        spatial_curvi.make_rhs_curvilinear(basis, inverted, bcs, **kw)
    assert isinstance(bcs["W"], BoundarySide) and not isinstance(
        bcs["S"], SegmentedSide)
