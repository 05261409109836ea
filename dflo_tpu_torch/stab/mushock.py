"""The artificial-viscosity field mu_shock (src/mu_shock.cc:41-374).

The torch counterpart of dflo_tpu/stab/mushock.py.  Per cell:

    mu = diffusion_coef * diameter^2 * (mean max-eigenvalue)
         / (integral of density)
         * sum over faces of  oint (V+ - V-) . (W+ - W-) ds,

the jump product of the entropy variables V and the state W integrated
over the cell boundary (shock_face_term / shock_boundary_term,
src/mu_shock.cc:120-287), then the cell scaling of shock_cell_term
(src/mu_shock.cc:77-93).  A boundary face takes the jump against the
side's ghost state (solver/spatial.segment_ghost, the one the residual
uses), a periodic side the wrapped neighbor's trace.

The reference leaves the terms that would apply this viscosity to the
residual commented out (src/assemble_explicit.cc:100-107, 223-240,
358-378), so the field is a diagnostic written with the solution (the
CLI's `diffusion coefficient`); ``make_laplacian_diffusion`` is the opt-in
cellwise Laplacian term, which no path of the port or the reference
enables.  Plain torch on every device, as the reference's is XLA.
"""

from __future__ import annotations

import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.basis import EAST, NORTH, SOUTH, WEST
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply, quad_reduce1
from dflo_tpu_torch.physics import euler


def make_mu_shock(basis: basis_mod.Basis, mesh, diffusion_coef: float,
                  per_x: bool = False, per_y: bool = False, *,
                  dtype: torch.dtype, device, bcs: dict | None = None):
    """Build mu(u, ubar, t=0.0) -> [ny, nx] on a Cartesian mesh.

    bcs: the four sides ({'W','E','S','N'} -> BoundarySide or
    SegmentedSide): each face on a side that is not periodic takes the jump
    against its ghost state (shock_boundary_term, src/mu_shock.cc:120-190);
    without bcs those faces contribute no jump."""
    from dflo_tpu_torch.solver.spatial import (NORMALS, segment_ghost,
                                               segmented_sides)
    faceV = [as_tensor(basis.faceV[f], dtype, device) for f in range(4)]
    wq = as_tensor(basis.wq, dtype, device)
    V = as_tensor(basis.V, dtype, device)
    wq2 = as_tensor(basis.wq2, dtype, device)
    dx, dy = mesh.dx, mesh.dy
    diam2 = dx * dx + dy * dy
    area = dx * dy
    # the wrapped slab of a non-periodic axis carries no interior face
    inner = {(2, 1): (slice(None), 0), (2, -1): (slice(None), -1),
             (1, 1): (0, slice(None)), (1, -1): (-1, slice(None))}

    sides = {}
    if bcs is not None:
        segged, sel = segmented_sides(bcs, mesh, device)
        for name, f, idx in (("W", WEST, (slice(None), 0)),
                             ("E", EAST, (slice(None), -1)),
                             ("S", SOUTH, (0, slice(None))),
                             ("N", NORTH, (-1, slice(None)))):
            if per_x if name in "WE" else per_y:
                continue
            xb, yb = mesh.face_coords(f, basis.xq)
            sides[name] = (f, idx, segged[name], sel[name],
                           dy if name in "WE" else dx,
                           as_tensor(xb, dtype, device),
                           as_tensor(yb, dtype, device))

    def face_term(Wp, Wm, ds):
        dV = euler.entropy_var(Wp) - euler.entropy_var(Wm)
        return quad_reduce1(wq, torch.sum(dV * (Wp - Wm), dim=0)) * ds

    def mu(u, ubar, t=0.0):
        if diffusion_coef == 0.0:
            return torch.zeros(u.shape[-2:], dtype=dtype, device=u.device)
        tr = [basis_apply(faceV[f], u) for f in range(4)]   # [4, nq, ny, nx]
        jump = torch.zeros(u.shape[-2:], dtype=dtype, device=u.device)
        specs = ((WEST, EAST, 2, 1, per_x, dy), (EAST, WEST, 2, -1, per_x, dy),
                 (SOUTH, NORTH, 1, 1, per_y, dx),
                 (NORTH, SOUTH, 1, -1, per_y, dx))
        for f, fo, axis, shift, per, ds in specs:
            fj = face_term(tr[f], torch.roll(tr[fo], shift, dims=axis + 1),
                           ds)
            if not per:
                fj[inner[(axis, shift)]] = 0.0
            jump = jump + fj

        # boundary faces: trace-vs-ghost jumps (shock_boundary_term)
        for name, (f, idx, side, sel, ds, xb, yb) in sides.items():
            Wp = tr[f][(slice(None), slice(None)) + idx]
            Wm = segment_ghost(side, sel, *NORMALS[name], Wp, xb, yb, t)
            jump[idx] = jump[idx] + face_term(Wp, Wm, ds)

        Wq = basis_apply(V, u)                       # volume quadrature states
        density_norm = quad_reduce1(wq2, Wq[euler.RHO]) * area
        avg_speed = quad_reduce1(wq2, euler.max_eigenvalue(Wq))
        return diffusion_coef * diam2 * avg_speed / density_norm * jump

    return mu


def make_laplacian_diffusion(basis: basis_mod.Basis, mesh, *,
                             dtype: torch.dtype, device):
    """The opt-in application of mu_shock as a cellwise Laplacian viscosity
    (the commented-out volume term mu grad(W) . grad(phi),
    src/assemble_explicit.cc:100-107): extra_rhs(u, mu) -> the term to ADD
    to du/dt, the diagonal mass solve included.  Disabled in the reference
    and here: no solver path calls it."""
    GxW = as_tensor(basis.wq2[:, None] * basis.Gx, dtype, device)
    GyW = as_tensor(basis.wq2[:, None] * basis.Gy, dtype, device)
    Gx = as_tensor(basis.Gx, dtype, device)
    Gy = as_tensor(basis.Gy, dtype, device)
    minv = as_tensor(1.0 / basis.mass, dtype, device)
    dx, dy = mesh.dx, mesh.dy
    area = dx * dy

    def extra_rhs(u, mu):
        dWx = basis_apply(Gx, u) / dx
        dWy = basis_apply(Gy, u) / dy
        mub = mu[None, None]
        R = -(dy * basis_apply(GxW.T, mub * dWx)
              + dx * basis_apply(GyW.T, mub * dWy))
        return R * (minv[None, :, None, None] / area)

    return extra_rhs
