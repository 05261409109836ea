"""TVB minmod slope limiter for the nodal Qk and modal Pk bases, vectorized
over all cells.

The torch counterpart of dflo_tpu/stab/limiter.py's gradient-based Qk limiter
(apply_limiter_TVB_Qk, src/limiter.cc:224-370) and modal Pk limiter
(apply_limiter_TVB_Pk, src/limiter.cc:376-516), with the angular-momentum
correction of the limited slopes (src/limiter.cc:496-500), and of its
Barth-Jespersen-type minmax limiter on Qk (apply_limiter_minmax_Qk,
src_mpi/limiter.cc:397-555): neighbor lookups are tensor rolls of the
cell-average field, the characteristic transform is a batched 4x4
contraction (src/equation.h:225-306; minmax: along the streamline,
src_mpi/equation.h:300-331), and the "reduce to linear" rewrite is a select
between the original DoFs and the limited linear rebuild.  No kernel
carries these two options: the reference runs them on XLA too
(dflo_tpu/driver.py:124-134).
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.contract import as_tensor, basis_reduce, recip
from dflo_tpu_torch.physics import euler


def minmod(a, b, c, Mdx2):
    """TVB minmod (src/limiter.cc:15-30): pass-through below the TVB
    threshold, sign-matched minimum otherwise."""
    samesign = (a * b > 0) & (b * c > 0)
    m = torch.sign(a) * torch.minimum(torch.abs(a),
                                      torch.minimum(torch.abs(b), torch.abs(c)))
    return torch.where(torch.abs(a) < Mdx2, a,
                       torch.where(samesign, m, torch.zeros_like(m)))


def _mean4(a):
    """Mean over the 4 components, summed in component order."""
    return (a[0] + a[1] + a[2] + a[3]) * 0.25


def neighbor_valid(shape, per_x: bool, per_y: bool,
                   mask: np.ndarray | None = None):
    """Bool numpy [ny, nx] flags (W, E, S, N): does a usable (in-domain,
    fluid) neighbor exist in that direction?  (The reference's lcell/rcell/
    bcell/tcell tables, src/claw.cc:336-380, plus the solid-cell mask.)"""
    m = np.ones(shape, bool) if mask is None else np.asarray(mask, bool)

    def shifted(axis, shift, periodic):
        s = np.roll(m, shift, axis=axis)
        if not periodic:
            if axis == 1 and shift == 1:
                s[:, 0] = False
            elif axis == 1:
                s[:, -1] = False
            elif shift == 1:
                s[0, :] = False
            else:
                s[-1, :] = False
        return s

    return (shifted(1, 1, per_x), shifted(1, -1, per_x),
            shifted(0, 1, per_y), shifted(0, -1, per_y))


def neighbor_diffs(ubar, D, valid):
    """Backward/forward cell-average differences with the reference's
    boundary fallback: where a neighbor is missing the difference degrades to
    the cell's own slope D (src/limiter.cc:283-316).

    ubar [4, ny, nx]; D = (Dx, Dy) each [4, ny, nx]; valid = (W, E, S, N)
    bool tensors.  Returns (dbx, dfx, dby, dfy)."""
    Dx, Dy = D
    vW, vE, vS, vN = valid
    dbx = torch.where(vW, ubar - torch.roll(ubar, 1, dims=-1), Dx)
    dfx = torch.where(vE, torch.roll(ubar, -1, dims=-1) - ubar, Dx)
    dby = torch.where(vS, ubar - torch.roll(ubar, 1, dims=-2), Dy)
    dfy = torch.where(vN, torch.roll(ubar, -1, dims=-2) - ubar, Dy)
    return dbx, dfx, dby, dfy


def make_tvb_limiter(basis: basis_mod.Basis, mesh, M: float = 0.0,
                     beta: float = 1.0, char_lim: bool = False,
                     conserve_angular_momentum: bool = False,
                     per_x: bool = False, per_y: bool = False,
                     mask: np.ndarray | None = None, *,
                     dtype: torch.dtype, device):
    """Build limit(u, ubar, marked, valid=None) -> u for the nodal Qk and GLL
    bases or the modal Pk basis.  mask: optional bool [ny, nx] fluid flags; a solid
    neighbor counts as a missing one (neighbor_valid).  valid: the call's
    own neighbor-exists flags (W, E, S, N), bool [ny, nx] each, in place of
    the mesh's (the post's block form passes those of a framed block).

    marked : [ny, nx] shock indicator; cells with marked > 1 are limited
             (src/limiter.cc:263).
    M, beta, char_lim mirror Parameters::Limiter (src/parameters.h:241-256);
    conserve_angular_momentum rewrites the limited y-slope of mx and x-slope
    of my so that their difference keeps the cell's own
    (src/limiter.cc:422, :496-500), on either basis.
    Pk (apply_limiter_TVB_Pk, src/limiter.cc:376-516): the slopes are the
    (1,0) and (0,1) Legendre coefficients times sqrt(3), beta is halved, and
    the rebuild keeps [mean, x-slope, y-slope] and zeroes the other modes.
    """
    if basis.family not in ("Qk", "Qk_gll", "Pk"):
        raise NotImplementedError(
            f"the TVB limiter of the port takes Qk, GLL or Pk, not "
            f"{basis.family}")
    modal = basis.family == "Pk"
    p = basis.degree
    h = mesh.diameter_h
    inv_h = 1.0 / h
    Mdx2 = M * h * h
    sqrt3 = float(np.sqrt(3.0))
    valid_mesh = tuple(torch.as_tensor(v, device=device) for v in
                       neighbor_valid((mesh.ny, mesh.nx), per_x, per_y,
                                      mask))
    if modal:
        ix_x, ix_y = 1, p + 1       # (1,0) / (0,1) modes (src/limiter.cc:414)
        beta_eff = 0.5 * beta       # src/limiter.cc:395
        keep = torch.zeros(basis.K, dtype=dtype, device=device)
        keep[0] = 1.0
        ex = torch.zeros(basis.K, dtype=dtype, device=device)
        ex[ix_x] = 1.0
        ey = torch.zeros(basis.K, dtype=dtype, device=device)
        ey[ix_y] = 1.0
        inv_sqrt3 = recip(sqrt3, ey)    # as csrc/fused_pk_post.cu multiplies
    else:
        beta_eff = beta
        # mean reference gradient operators: gx[k] = sum_q w2q dphi_k/dx
        gx_op = as_tensor(basis.wq2 @ basis.Gx, dtype, device)
        gy_op = as_tensor(basis.wq2 @ basis.Gy, dtype, device)
        # physical node offsets from the cell center
        drx = as_tensor((basis.nodes[:, 0] - 0.5) * mesh.dx, dtype, device)
        dry = as_tensor((basis.nodes[:, 1] - 0.5) * mesh.dy, dtype, device)

    def limit(u, ubar, marked, valid=None):
        if modal:
            Dx = sqrt3 * u[:, ix_x]                      # [4, ny, nx]
            Dy = sqrt3 * u[:, ix_y]
        else:
            # h * mean physical gradient (src/limiter.cc:269-281)
            Dx = (h / mesh.dx) * basis_reduce(gx_op, u)
            Dy = (h / mesh.dy) * basis_reduce(gy_op, u)
        ang_mom = Dx[euler.MY] - Dy[euler.MX]           # src/limiter.cc:422
        dbx, dfx, dby, dfy = neighbor_diffs(
            ubar, (Dx, Dy), valid_mesh if valid is None else valid)

        if char_lim:
            Rx, Lx, Ry, Ly = euler.eigen_matrices(ubar)
            cDx = euler.to_characteristic(Lx, Dx)
            cDy = euler.to_characteristic(Ly, Dy)
            cdbx = euler.to_characteristic(Lx, dbx)
            cdfx = euler.to_characteristic(Lx, dfx)
            cdby = euler.to_characteristic(Ly, dby)
            cdfy = euler.to_characteristic(Ly, dfy)
        else:
            cDx, cDy, cdbx, cdfx, cdby, cdfy = Dx, Dy, dbx, dfx, dby, dfy

        Dxn = minmod(cDx, beta_eff * cdbx, beta_eff * cdfx, Mdx2)
        Dyn = minmod(cDy, beta_eff * cdby, beta_eff * cdfy, Mdx2)
        # the component means summed in order, as csrc/fused_post.cu does
        change = (_mean4(torch.abs(Dxn - cDx))
                  + _mean4(torch.abs(Dyn - cDy)))
        if char_lim:
            Dxn = euler.to_conserved(Rx, Dxn)
            Dyn = euler.to_conserved(Ry, Dyn)
        if conserve_angular_momentum:                   # src/limiter.cc:496
            Dyn_mx = 0.5 * (Dyn[euler.MX] - (ang_mom - Dxn[euler.MY]))
            Dxn_my = ang_mom + Dyn_mx
            Dyn = torch.stack([Dyn_mx, Dyn[euler.MY], Dyn[euler.RHO],
                               Dyn[euler.ENE]])
            Dxn = torch.stack([Dxn[euler.MX], Dxn_my, Dxn[euler.RHO],
                               Dxn[euler.ENE]])

        if modal:
            # keep [mean, x-slope, y-slope], zero the rest; mode 0 takes
            # the average itself, as dflo_tpu/stab/limiter.py does
            u_lim = (ubar[:, None] * keep[None, :, None, None]
                     + (Dxn * inv_sqrt3)[:, None] * ex[None, :, None, None]
                     + (Dyn * inv_sqrt3)[:, None] * ey[None, :, None, None])
        else:
            # linear rebuild at the nodal points (src/limiter.cc:355-366)
            u_lim = (ubar[:, None]
                     + drx[None, :, None, None] * (Dxn * inv_h)[:, None]
                     + dry[None, :, None, None] * (Dyn * inv_h)[:, None])
        active = (marked > 1.0) & (change > 1.0e-10)
        return torch.where(active[None, None], u_lim, u)

    return limit


def make_minmax_limiter(basis: basis_mod.Basis, mesh, M: float = 0.0,
                        char_lim: bool = False, per_x: bool = False,
                        per_y: bool = False, mask: np.ndarray | None = None,
                        *, dtype: torch.dtype, device):
    """Build limit(u, ubar, marked) -> u: the Barth-Jespersen-type minmax
    limiter (apply_limiter_minmax_Qk, src_mpi/limiter.cc:397-555,
    dflo_tpu/stab/limiter.py:169-249).  Per cell, the mean gradient is
    scaled by the largest theta <= 1 that keeps the four face-centre
    reconstructions within the min/max of the cell averages over the cell
    and its existing neighbors (characteristic: the streamline eigenvectors
    of the cell's average, src_mpi/equation.h:300-331); marked > 1 cells
    whose mean theta is below 0.99 are rebuilt linearly.  The nodal Qk and
    GLL bases only: the src_mpi tree has no modal form (ValueError on
    Pk)."""
    if basis.family == "Pk":
        raise ValueError("minmax limiter is implemented for nodal Qk bases "
                         "(src_mpi tree is Qk-only)")
    h = mesh.diameter_h
    Mdx2 = M * h * h
    gx_op = as_tensor(basis.wq2 @ basis.Gx, dtype, device)
    gy_op = as_tensor(basis.wq2 @ basis.Gy, dtype, device)
    drx = as_tensor((basis.nodes[:, 0] - 0.5) * mesh.dx, dtype, device)
    dry = as_tensor((basis.nodes[:, 1] - 0.5) * mesh.dy, dtype, device)
    valid = tuple(torch.as_tensor(v, device=device) for v in
                  neighbor_valid((mesh.ny, mesh.nx), per_x, per_y, mask))
    vW, vE, vS, vN = valid
    inf = float("inf")

    def limit(u, ubar, marked):
        # mean physical gradients (src_mpi/limiter.cc:478-494)
        Dx = basis_reduce(gx_op, u) / mesh.dx
        Dy = basis_reduce(gy_op, u) / mesh.dy
        if char_lim:
            R, L = euler.streamline_eigen_matrices(ubar)
            a_c = euler.to_characteristic(L, ubar)
            cDx = euler.to_characteristic(L, Dx)
            cDy = euler.to_characteristic(L, Dy)
        else:
            a_c, cDx, cDy = ubar, Dx, Dy

        amin, amax = a_c, a_c
        for shift, axis, v in ((1, -1, vW), (-1, -1, vE),
                               (1, -2, vS), (-1, -2, vN)):
            a = torch.roll(ubar, shift, dims=axis)
            if char_lim:
                a = euler.to_characteristic(L, a)
            # a missing neighbor is a +-inf sentinel (no bound)
            amin = torch.minimum(amin, torch.where(v, a, inf))
            amax = torch.maximum(amax, torch.where(v, a, -inf))

        dumin = amin - a_c
        dumax = amax - a_c
        gate = (dumax - dumin) > Mdx2            # src_mpi/limiter.cc:505-507
        theta = torch.ones_like(a_c)
        for du in (0.5 * mesh.dx * cDx, -0.5 * mesh.dx * cDx,
                   0.5 * mesh.dy * cDy, -0.5 * mesh.dy * cDy):
            dus = torch.where(du == 0.0, 1.0, du)
            t = torch.where(du > 0.0, dumax / dus,
                            torch.where(du < 0.0, dumin / dus, inf))
            theta = torch.minimum(theta, torch.where(gate, t, inf))
        theta = torch.clamp(theta, max=1.0)

        change = torch.mean(theta, dim=0)          # src_mpi/limiter.cc:519
        Dxn = cDx * theta
        Dyn = cDy * theta
        if char_lim:
            Dxn = euler.to_conserved(R, Dxn)
            Dyn = euler.to_conserved(R, Dyn)
        u_lim = (ubar[:, None]
                 + drx[None, :, None, None] * Dxn[:, None]
                 + dry[None, :, None, None] * Dyn[:, None])
        active = (marked > 1.0) & (change < 0.99)
        return torch.where(active[None, None], u_lim, u)

    return limit
