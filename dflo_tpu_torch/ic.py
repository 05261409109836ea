"""Analytic initial conditions and their interpolation / projection onto
the DG space.

The torch counterpart of dflo_tpu/ic.py (after src/ic.{h,cc} and
src_gll/ic.{h,cc}): the named analytic states as closures over coordinate
tensors ``fn(x, y, t) -> [4, ...]`` in the caller's dtype and device, the
cell-centred setters ``fn(x, y, xc, yc, t)``, the basis-dependent setter
(nodal interpolation for Qk, set_initial_condition_Qk, src/ic.cc:104-121;
the L2 projection for the modal Pk basis, src/ic.cc:128-168), the
cell-centred setter and the L2 error against an analytic state.  A
compiled .prm expression (config/expressions) plugs in through the same
callable interface.  The gravity ICs are here as functions; their configs
raise in the CLI until body forces are ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import quadrature
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply
from dflo_tpu_torch.physics.euler import GAMMA


def _where(cond, a: float, b: float, like):
    """a where cond, else b, in like's dtype and device."""
    return torch.where(cond, torch.full_like(like, a),
                       torch.full_like(like, b))


def _state(rho, vex, vey, pre):
    """(rho, vx, vy, p) -> the conserved layout (mx, my, rho, E)."""
    return torch.stack([rho * vex, rho * vey, rho,
                        pre / (GAMMA - 1.0)
                        + 0.5 * rho * (vex**2 + vey**2)])


def isentropic_vortex(beta: float = 5.0, x0: float = 0.0, y0: float = 0.0):
    """IsentropicVortex(beta, x0, y0) of src/ic.h:28-53 / src/ic.cc:44-61:
    a stationary vortex (no advection), whose exact solution at any time
    is the IC (examples/isentropic_vortex)."""
    a1 = 0.5 * beta / np.pi
    a2 = (GAMMA - 1.0) * a1 * a1 / 2.0

    def fn(x, y, t=0.0):
        r2 = (x - x0) ** 2 + (y - y0) ** 2
        rho = (1.0 - a2 * torch.exp(1.0 - r2)) ** (1.0 / (GAMMA - 1.0))
        vex = -a1 * (y - y0) * torch.exp(0.5 * (1.0 - r2))
        vey = a1 * (x - x0) * torch.exp(0.5 * (1.0 - r2))
        return _state(rho, vex, vey, rho ** GAMMA)

    return fn


def isentropic_vortex_steady(beta: float = 5.0, x0: float = 0.0,
                             y0: float = 0.0):
    """The exactly steady isentropic vortex (Shu's scaling, a2 =
    (g-1) a1^2 / (2g)); the reference's IC omits the 1/gamma (src/ic.h:
    43-44), so its vortex is not an exact Euler solution."""
    a1 = 0.5 * beta / np.pi
    a2 = (GAMMA - 1.0) * a1 * a1 / (2.0 * GAMMA)

    def fn(x, y, t=0.0):
        r2 = (x - x0) ** 2 + (y - y0) ** 2
        T = 1.0 - a2 * torch.exp(1.0 - r2)
        rho = T ** (1.0 / (GAMMA - 1.0))
        vex = -a1 * (y - y0) * torch.exp(0.5 * (1.0 - r2))
        vey = a1 * (x - x0) * torch.exp(0.5 * (1.0 - r2))
        return _state(rho, vex, vey, rho * T)

    return fn


def rayleigh_taylor(gravity: float, Lx: float = 0.5, Ly: float = 1.5,
                    A: float = 0.01, P0: float = 2.5):
    """RayleighTaylor IC (src/ic.h:10-27, src/ic.cc:12-38)."""

    def fn(x, y, t=0.0):
        rho = _where(y < 0.0, 1.0, 2.0, y)
        vel = A * (1.0 + torch.cos(2.0 * np.pi * x / Lx)) / 2.0 \
            * (1.0 + torch.cos(2.0 * np.pi * y / Ly)) / 2.0
        pre = P0 - gravity * rho * y
        return torch.stack([torch.zeros_like(rho), rho * vel, rho,
                            pre / (GAMMA - 1.0) + 0.5 * rho * vel * vel])

    return fn


def vortex_system():
    """Three-vortex system (src/ic.h:55-84, src/ic.cc:67-100)."""
    beta, Rc = 5.0, 4.0
    a1 = 0.5 * beta / np.pi
    a2 = (GAMMA - 1.0) * a1 * a1 / 2.0
    xs = [0.0, Rc * np.cos(np.pi / 6.0), -Rc * np.cos(np.pi / 6.0)]
    ys = [-Rc, Rc * np.sin(np.pi / 6.0), Rc * np.sin(np.pi / 6.0)]

    def fn(x, y, t=0.0):
        rho = torch.zeros_like(x)
        vex = torch.zeros_like(x)
        vey = torch.zeros_like(x)
        for xi, yi in zip(xs, ys):
            r2 = (x - xi) ** 2 + (y - yi) ** 2
            rho = rho + (1.0 - a2 * torch.exp(1.0 - r2)) ** (1.0
                                                              / (GAMMA - 1.0))
            vex = vex - a1 * (y - yi) * torch.exp(0.5 * (1.0 - r2))
            vey = vey + a1 * (x - xi) * torch.exp(0.5 * (1.0 - r2))
        rho = rho - 2.0
        vex = vex / 3.0
        vey = vey / 3.0
        pre = rho ** GAMMA
        # high-pressure patch near the origin (src/ic.cc:90)
        pre = torch.where((torch.abs(x) < 0.1) & (torch.abs(y) < 0.1),
                          torch.full_like(pre, 50.0), pre)
        return _state(rho, vex, vey, pre)

    return fn


def polytropic_hydrostatic(nu: float = 1.2, p0: float = 1.0,
                           rho0: float = 1.0, alpha: float = 1.0):
    """Polytropic hydrostatic equilibrium, phi = y (src_gll/ic.h:11-27,
    src_gll/ic.cc:13-29)."""

    def fn(x, y, t=0.0):
        rho = (rho0 ** (nu - 1.0) - alpha * (nu - 1.0) / nu * y) \
            ** (1.0 / (nu - 1.0))
        pre = alpha * rho ** nu
        z = torch.zeros_like(x)
        return torch.stack([z, z, rho, pre / (GAMMA - 1.0)])

    return fn


def isothermal_hydrostatic(eta: float = 0.0, rho0: float = 1.21,
                           p0: float = 1.0, g: float = 1.0):
    """Xing-Shu isothermal equilibrium with an optional Gaussian pressure
    perturbation eta, phi = g (x + y) (src_gll/ic.h:72-89,
    src_gll/ic.cc:106-122)."""

    def fn(x, y, t=0.0):
        ff1 = -(rho0 * g) / p0 * (x + y)
        ff2 = -(100.0 * rho0 * g) / p0 * ((x - 0.3) ** 2 + (y - 0.3) ** 2)
        rho = rho0 * torch.exp(ff1)
        pre = p0 * torch.exp(ff1) + eta * torch.exp(ff2)
        z = torch.zeros_like(x)
        return torch.stack([z, z, rho, pre / (GAMMA - 1.0)])

    return fn


def radial_rayleigh_taylor(r0: float = 0.6, eta: float = 0.02,
                           k: float = 20.0, drho: float = 0.1):
    """Radial Rayleigh-Taylor in a radial gravity field, phi = r
    (src_gll/ic.h:51-67, src_gll/ic.cc:67-100)."""
    alpha = np.exp(-r0) / (np.exp(-r0) + drho)
    factor = np.exp(r0 * (1.0 - alpha) / alpha)

    def fn(x, y, t=0.0):
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(y, x)
        pre = torch.where(r < r0, torch.exp(-r), factor * torch.exp(-r / alpha))
        ds = 0.01
        ri = r0 * (1.0 + eta * torch.cos(k * theta))
        H = 0.5 * (1.0 - torch.tanh((r - ri) / ds))
        rho = (torch.exp(-r) * H
               + factor / alpha * torch.exp(-r / alpha) * (1.0 - H))
        z = torch.zeros_like(x)
        return torch.stack([z, z, rho, pre / (GAMMA - 1.0)])

    return fn


def unsteady_gravity(u0: float = 1.0, v0: float = 1.0, p0: float = 4.5):
    """Xing-Shu sec. 5.4's exact unsteady solution in a linear field,
    phi = x + y (src_gll/ic.h:92-110, src_gll/ic.cc:128-146)."""

    def fn(x, y, t=0.0):
        rho = 1.0 + 0.2 * torch.sin(np.pi * (x + y - t * (u0 + v0)))
        pre = (p0 - x - y + t * (u0 + v0)
               + 0.2 * torch.cos(np.pi * (x + y - t * (u0 + v0))) / np.pi)
        return torch.stack([rho * u0, rho * v0, rho,
                            pre / (GAMMA - 1.0)
                            + 0.5 * (u0 * u0 + v0 * v0) * rho])

    return fn


def keplerian_disk(r0: float = 0.5, r1: float = 2.0, rs: float = 0.01,
                   rho_out: float = 1.0e-6, rho_disk: float = 1.0,
                   p0: float = 1.0e-6):
    """Rotating Keplerian disk (src_mpi/ic.h:95-115, src_mpi/ic.cc:103-130;
    the reference marks it TO BE COMPLETED: its declared parameters and a
    v_theta = 1/sqrt(r) profile)."""

    def fn(x, y, t=0.0):
        r = torch.sqrt(x * x + y * y)
        vtheta = 1.0 / torch.sqrt(r)
        vex = -vtheta * y / r
        vey = vtheta * x / r
        rho = _where((r < r0 - rs) | (r > r1 + rs), rho_out, rho_disk, r)
        return torch.stack([rho * vex, rho * vey, rho,
                            p0 / (GAMMA - 1.0)
                            + 0.5 * rho * (vex**2 + vey**2)])

    return fn


def rayleigh_taylor_gll(gravity: float = 1.0, eta: float = 0.01,
                        P0: float = 2.5):
    """The src_gll Rayleigh-Taylor setter (src_gll/ic.cc:226-284): the
    density jump placed by the cell centre (1 below, 2 above y = 0), the
    hydrostatic pressure from the pointwise y and a localised y-velocity
    perturbation eta sin(4 pi x) exp(-50 y^2)."""

    def fn(x, y, xc, yc, t=0.0):
        rho = _where(yc < 0.0, 1.0, 2.0, yc) * torch.ones_like(y)
        pre = P0 - gravity * torch.where(y < 0.0, y, 2.0 * y)
        v = eta * torch.sin(4.0 * np.pi * x) * torch.exp(-50.0 * y * y)
        return torch.stack([torch.zeros_like(x), rho * v, rho,
                            pre / (GAMMA - 1.0) + 0.5 * rho * v * v])

    return fn


def shocktube_gll():
    """The src_gll Sod setter with the jump placed by the cell centre
    (set_initial_condition_shocktube, src_gll/ic.cc:289-345)."""

    def fn(x, y, xc, yc, t=0.0):
        rho = _where(xc < 0.5, 1.0, 0.125, xc) * torch.ones_like(x)
        E = _where(xc < 0.5, 2.5, 0.25, xc) * torch.ones_like(x)
        z = torch.zeros_like(x)
        return torch.stack([z, z, rho, E])

    return fn


def _gravity(params) -> float:
    return getattr(params, "gravity", 1.0) if params is not None else 1.0


#: the named ICs by the reference's ic_function names (src/ic.cc:104-121,
#: src_gll/ic.cc:354-377)
IC_FUNCTIONS = {
    "isenvort": lambda params=None: isentropic_vortex(5.0, 0.0, 0.0),
    "vortsys": lambda params=None: vortex_system(),
    "rt": lambda params=None: rayleigh_taylor(_gravity(params)),
    "rrt": lambda params=None: radial_rayleigh_taylor(),
    "isohydro": lambda params=None: isothermal_hydrostatic(),
    "polyhydro": lambda params=None: polytropic_hydrostatic(1.2),
    "keplerian": lambda params=None: keplerian_disk(),
}

#: the setters that branch on the cell centre (through
#: set_initial_condition_cellcentered; src_gll/ic.cc:226-345)
IC_CELLWISE = {
    "shocktube": lambda params=None: shocktube_gll(),
    "rt_gll": lambda params=None: rayleigh_taylor_gll(_gravity(params)),
}


def set_initial_condition(basis: basis_mod.Basis, mesh, fn, t: float = 0.0, *,
                          dtype: torch.dtype, device) -> torch.Tensor:
    """Project an analytic state fn(x, y, t) -> [4, ...] onto u[4, K, ny, nx].

    Qk / Qk_gll: nodal interpolation.  Pk: L2 projection with QGauss(p+1),
    coef = M^-1 int f phi (the cell Jacobian cancels against M^-1)."""
    if basis.family in ("Qk", "Qk_gll"):
        xn, yn = mesh.point_coords(basis.nodes)
        u = fn(as_tensor(xn, dtype, device), as_tensor(yn, dtype, device), t)
        return u.to(dtype=dtype, device=device).contiguous()
    pts, w2 = _tensor_points(basis.degree + 1)
    xqq, yqq = mesh.point_coords(pts)
    f = fn(as_tensor(xqq, dtype, device), as_tensor(yqq, dtype, device), t)
    proj = as_tensor(w2[:, None] * basis.eval_at(pts), dtype, device)  # [Q, K]
    u = basis_apply(proj.T, f.to(dtype=dtype, device=device)) \
        * as_tensor(1.0 / basis.mass, dtype, device)[None, :, None, None]
    return u.contiguous()


def set_initial_condition_cellcentered(basis: basis_mod.Basis, mesh, fn,
                                       t: float = 0.0, *, dtype: torch.dtype,
                                       device) -> torch.Tensor:
    """Nodal interpolation where the IC may branch on the CELL CENTRE (the
    src_gll setters place density jumps cell-wise so that no jump straddles
    a cell, src_gll/ic.cc:226-345): fn(x, y, xc, yc, t) -> [4, ...] with
    the nodal (x, y) [K, ny, nx] and the per-cell (xc, yc) [1, ny, nx]."""
    xn, yn = mesh.point_coords(basis.nodes)
    xc, yc = mesh.cell_centers()
    u = fn(as_tensor(xn, dtype, device), as_tensor(yn, dtype, device),
           as_tensor(xc, dtype, device)[None],
           as_tensor(yc, dtype, device)[None], t)
    return u.to(dtype=dtype, device=device).contiguous()


def _tensor_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n x n Gauss tensor points on the reference cell (x fastest) and
    their weights."""
    xq, wq = quadrature.gauss(n)
    QX, QY = np.meshgrid(xq, xq, indexing="xy")
    return (np.stack([QX.ravel(), QY.ravel()], axis=1),
            np.outer(wq, wq).ravel())


def l2_error(basis: basis_mod.Basis, mesh, u, exact_fn, t: float = 0.0,
             nq: int | None = None) -> torch.Tensor:
    """Per-component L2 error against an analytic state, normalised by the
    domain area (compute_errors, src_gll/claw.cc:1190-1246), with nq x nq
    Gauss points per cell (default degree + 2).  Returns [4]."""
    pts, w2 = _tensor_points(nq or (basis.degree + 2))
    dtype, device = u.dtype, u.device
    xqq, yqq = mesh.point_coords(pts)
    uh = basis_apply(as_tensor(basis.eval_at(pts), dtype, device), u)
    ue = exact_fn(as_tensor(xqq, dtype, device), as_tensor(yqq, dtype, device),
                  t)
    err2 = torch.sum(as_tensor(w2, dtype, device)[None, :, None, None]
                     * (uh - ue) ** 2, dim=(1, 2, 3)) * (mesh.dx * mesh.dy)
    domain_area = (mesh.x1 - mesh.x0) * (mesh.y1 - mesh.y0)
    return torch.sqrt(err2 / domain_area)
