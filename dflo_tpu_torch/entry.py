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
           flux: str = "hllc", degree: int = 2):
    """(solver, u0) of the DMR configuration on an nx x ny mesh, with the
    HLLC flux unless `flux` names another, on Q2 (P2 for MOOD) unless
    `degree` names another; u0 is the nodal interpolant (Qk) or the L2
    projection (Pk) of the IC, a whole state on `device` (under a device
    mesh, ``solver.shard(u0)`` splits it)."""
    basis = make_basis("Pk" if method == "mood" else "Qk", degree)
    mesh = CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0)
    bcs = dict(W=BoundarySide(euler.BC_INFLOW, dmr_inflow),
               E=BoundarySide(euler.BC_OUTFLOW),
               S=BoundarySide(euler.BC_SLIP),
               N=BoundarySide(euler.BC_FARFIELD, dmr_inflow))
    lim = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    solver = Solver(basis, mesh, bcs, flux=flux, limiter=lim, cfl=0.5,
                    dtype=dtype, device=device, method=method,
                    device_mesh=device_mesh)
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
