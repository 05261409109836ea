"""Entry points of the port: the double-Mach-reflection (DMR) step.

The analogs of __graft_entry__._build and entry(): degree-2 elements on the
4 x 1 box, inflow (Mach-10 post-shock state) on the west side, outflow east,
slip wall south, farfield north, HLLC flux, characteristic TVB with the
KXRCF density indicator (beta = 2) and Zhang-Shu positivity, SSP-RK3 at
CFL 0.5 with a global dt.  ``method="rk"`` runs RK/TVB on the Q2 nodal Gauss
basis; ``method="mood"`` the MOOD cascade on the modal P2 basis (the
configuration of bench.py's headline metric).  Both run on the card unless
the caller asks for another device.  ``_build(..., device_mesh=dm)`` builds
the RK solver on a mesh of blocks (parallel/sharding) and
``dryrun_multichip`` steps it once, the analogs of
``__graft_entry__._build(..., device_mesh=...)`` and ``dryrun_multichip``.

``dmr_geo_text`` and ``dmr_geo_prm`` write the DMR as the reference's own
input describes it (examples/double_mach_reflection/grid.geo and
input.prm): a .geo box of two transfinite blocks whose bottom is split at
x = 1/6 (a segmented side: post-shock farfield before, slip wall after)
and a .prm that runs it through the CLI.
"""

from __future__ import annotations

import math

import torch

from dflo_tpu_torch import ic
from dflo_tpu_torch.driver import LimiterConfig, Solver
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops.basis import make_basis
from dflo_tpu_torch.parallel.sharding import device_mesh as make_device_mesh
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver.spatial import BoundarySide

#: the Mach-10 post-shock state (rho, vx, vy, p)
POST_SHOCK = (8.0, 7.14471, -4.125, 116.5)
#: the same state in the conserved layout (mx, my, rho, E)
POST_CONSERVED = (8.0 * 7.14471, -8.0 * 4.125, 8.0,
                  116.5 / 0.4 + 0.5 * 8.0 * (7.14471**2 + 4.125**2))


def dmr_inflow(x, y, t):
    """Post-shock inflow state in the conserved layout."""
    rho, vx, vy, p = POST_SHOCK
    return torch.stack(
        [torch.full_like(x, rho * vx), torch.full_like(x, rho * vy),
         torch.full_like(x, rho),
         torch.full_like(x, p / (euler.GAMMA - 1.0)
                         + 0.5 * rho * (vx**2 + vy**2))])


def dmr_ic(x, y, t=0.0):
    """Double-Mach-reflection-style Mach-10 oblique shock."""
    post = x < (1.0 / 6.0 + y / math.sqrt(3.0))

    def sel(a, b):
        return torch.where(post, torch.full_like(x, a), torch.full_like(x, b))

    rho = sel(8.0, 1.4)
    vx = sel(7.14471, 0.0)
    vy = sel(-4.125, 0.0)
    p = sel(116.5, 1.0)
    return torch.stack([rho * vx, rho * vy, rho,
                        p / (euler.GAMMA - 1.0) + 0.5 * rho * (vx**2 + vy**2)])


def contact_ic(x, y, t=0.0):
    """The post-shock state everywhere, its density halved for x >= 2: a
    contact discontinuity carried by the Mach-10 flow (no cell comes near
    the pressure floor)."""
    rho0, vx, vy, p = POST_SHOCK
    rho = torch.where(x < 2.0, rho0, 0.5 * rho0).to(x.dtype)
    return torch.stack([rho * vx, rho * vy, rho,
                        torch.full_like(x, p / (euler.GAMMA - 1.0))
                        + 0.5 * rho * (vx * vx + vy * vy)])


def _build(nx: int, ny: int, dtype: torch.dtype = torch.float64,
           device="cuda", method: str = "rk", device_mesh=None,
           flux: str = "hllc", degree: int = 2, family: str | None = None,
           limiter: LimiterConfig | None = None, **solver_kw):
    """(solver, u0) of the DMR configuration on an nx x ny mesh, with the
    HLLC flux unless `flux` names another, on Q2 (P2 for MOOD) unless
    `degree` or `family` names another, with characteristic TVB (beta 2),
    the density indicator and positivity unless `limiter` is given;
    solver_kw go to Solver (e.g. volume_kernel); u0 is the nodal
    interpolant (Qk) or the L2 projection (Pk) of the IC, a whole state on
    `device` (under a device mesh, ``solver.shard(u0)`` splits it)."""
    family = family or ("Pk" if method == "mood" else "Qk")
    basis = make_basis(family, degree)
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    bcs = dict(W=BoundarySide(euler.BC_INFLOW, dmr_inflow),
               E=BoundarySide(euler.BC_OUTFLOW),
               S=BoundarySide(euler.BC_SLIP),
               N=BoundarySide(euler.BC_FARFIELD, dmr_inflow))
    lim = limiter or LimiterConfig(type="TVB", shock_indicator="density",
                                   beta=2.0, char_lim=True, pos_lim=True)
    solver = Solver(basis, mesh, bcs, flux=flux, limiter=lim, cfl=0.5,
                    dtype=dtype, device=device, method=method,
                    device_mesh=device_mesh, **solver_kw)
    u0 = ic.set_initial_condition(basis, mesh, dmr_ic, dtype=dtype,
                                  device=device)
    return solver, u0


def entry(dtype: torch.dtype = torch.float64, device="cuda"):
    """(fn, example_args): one full solver step at 128 x 24.

    The example state is the initial condition after the stabilization
    chain, as ``Solver.run`` hands it to the first step (src/claw.cc:
    997-1001).  The JAX package's entry() steps the unlimited nodal
    interpolant of the shock instead, whose first step trips the fatal
    negative-average flag."""
    solver, u0 = _build(128, 24, dtype=dtype, device=device)
    u0 = solver.post_stage(u0)
    step = solver._make_step()

    def fn(u, t, t_end):
        u_new, _dt, _bad, _stats = step(u, t, t_end)
        return u_new

    return fn, (u0, torch.zeros((), dtype=dtype, device=device),
                torch.full((), 1.0e-3, dtype=dtype, device=device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded RK step over an n-block mesh (the most-square shape) on
    an 8 DX x 8 DY DMR grid, in float64, held against the single-device
    step.  All blocks sit on `device`: a virtual mesh, as the JAX dry run's
    virtual CPU devices (a mesh over distinct cards is
    ``device_mesh(devices=...)``)."""
    dev = torch.device(device)
    dm = make_device_mesh(devices=[dev] * n_devices)
    ny_dev, nx_dev = dm.shape
    solver, u0 = _build(8 * nx_dev, 8 * ny_dev, dtype=torch.float64,
                        device=dev, device_mesh=dm)
    single, _ = _build(8 * nx_dev, 8 * ny_dev, dtype=torch.float64,
                       device=dev)
    u0 = single.post_stage(u0)
    t, t_end = solver._scalar(0.0), solver._scalar(1.0e-3)
    blocks, dt, bad, _ = solver._make_step()(solver.shard(u0), t, t_end)
    ref, dt_ref, _, _ = single._make_step()(u0, t, t_end)
    u1 = solver.gather(blocks)
    assert len(blocks) == n_devices and not bool(bad)
    assert float(dt) == float(dt_ref)
    err = float((u1 - ref).abs().max() / ref.abs().max())
    assert err <= 1e-12, f"sharded step differs from one device by {err}"


def dmr_geo_text(nl: int, nr: int, ny: int) -> str:
    """The DMR box [0, 4] x [0, 1] as two transfinite blocks split at
    x = 1/6 (nl and nr cells across, ny up): Physical Line 0 on the bottom
    before the split, 1 after it, 2 on E, 3 on N, 4 on W."""
    return f"""// double Mach reflection, bottom split at x0 = 1/6
lx = 4.0; ly = 1.0; x0 = 1.0/6.0;
nl = {nl}; nr = {nr}; ny = {ny};
Point(1) = {{0, 0, 0}};
Point(2) = {{x0, 0, 0}};
Point(3) = {{lx, 0, 0}};
Point(4) = {{lx, ly, 0}};
Point(5) = {{x0, ly, 0}};
Point(6) = {{0, ly, 0}};
Line(1) = {{1, 2}};
Line(2) = {{2, 3}};
Line(3) = {{3, 4}};
Line(4) = {{4, 5}};
Line(5) = {{5, 6}};
Line(6) = {{6, 1}};
Line(7) = {{2, 5}};
Line Loop(1) = {{1, 7, 5, 6}};
Plane Surface(1) = {{1}};
Line Loop(2) = {{2, 3, 4, -7}};
Plane Surface(2) = {{2}};
Transfinite Line{{1, 5}} = nl + 1;
Transfinite Line{{2, 4}} = nr + 1;
Transfinite Line{{3, 6, 7}} = ny + 1;
Transfinite Surface{{1, 2}};
Recombine Surface{{1, 2}};
Physical Line(0) = {{1}};
Physical Line(1) = {{2}};
Physical Line(2) = {{3}};
Physical Line(3) = {{4, 5}};
Physical Line(4) = {{6}};
"""


#: the moving shock on the top edge and the oblique shock of the IC, as
#: .prm conditions (1 where post-shock)
SHOCK = "(x < 1.0/6.0 + (1.0 + 20.0*t)/sqrt(3.0))"
OBLIQUE = "(x < 1.0/6.0 + y/sqrt(3.0))"


def dmr_geo_prm(mesh_file: str, basis: str = "Qk", method: str = "rk3",
                out_iter: int = 1000) -> str:
    """The DMR of tests/test_masked_domain.py:66-110 as a .prm on a mesh
    file: the post-shock state on boundary 0 (farfield) and on W (4,
    inflow), slip on 1, the moving shock on N (3, farfield), outflow on E
    (2); the oblique Mach-10 shock as IC; Q2, hllc, characteristic TVB with
    beta 1 and the `limiter` indicator, positivity, cfl 0.4; a snapshot
    every out_iter steps."""
    post = "\n".join(f"   set w_{c} value = {v!r}" for c, v in
                     enumerate(POST_CONSERVED))

    def shocked(cond):
        return "\n".join([
            f"   set w_0 value = {POST_CONSERVED[0]!r}*{cond}",
            f"   set w_1 value = {POST_CONSERVED[1]!r}*{cond}",
            f"   set w_2 value = 8.0*{cond} + 1.4*(1 - {cond})",
            f"   set w_3 value = {POST_CONSERVED[3]!r}*{cond}"
            f" + 2.5*(1 - {cond})"])

    return f"""set mesh type = gmsh
set mesh file = {mesh_file}
set degree = 2
set basis = {basis}
set mapping = cartesian
subsection boundary_0
   set type = farfield
{post}
end
subsection boundary_1
   set type = slip
end
subsection boundary_2
   set type = outflow
end
subsection boundary_3
   set type = farfield
{shocked(SHOCK)}
end
subsection boundary_4
   set type = inflow
{post}
end
subsection initial condition
{shocked(OBLIQUE)}
end
subsection time stepping
   set time step type = global
   set cfl = 0.4
   set final time = 0.2
end
subsection linear solver
   set method = {method}
end
subsection output
   set iter step = {out_iter}
   set schlieren plot = true
end
subsection refinement
   set refinement = false
end
subsection flux
   set flux = hllc
end
subsection limiter
   set type = TVB
   set shock indicator = limiter
   set characteristic limiter = true
   set positivity limiter = true
   set beta = 1.0
end
"""
