"""DG residual on structured curvilinear blocks (`mapping = q1`).

The torch counterpart of dflo_tpu/solver/spatial_curvi.py: the
curvilinear form of solver/spatial.py's plain residual, where FEValues
supplies per-cell Jacobians, normals and JxW in the reference instead of
the Cartesian shortcuts.  The contraction structure over u[4, K, ny, nx]
is the Cartesian one, but

- the volume term contracts the flux against the contravariant metric
  combinations detJ*grad(phi) = (Gx*y_eta - Gy*y_xi, -Gx*x_eta + Gy*x_xi)
  computed once at the quadrature points of every cell,
- interface fluxes use the per-edge unit normals and edge lengths
  (bilinear cells have straight edges, so both are constant along each
  edge),
- the diagonal collocation mass is w_k * detJ_k per cell node
  (compute_inv_mass_matrix, src/claw.cc:228-258).

It takes the nodal-collocated Qk (Gauss) basis only; the reference
likewise restricts Pk and the TVB limiter to Cartesian mappings
(src/parameters.cc:545-550).  The reference keeps this path off its Pallas
kernels (dflo_tpu/driver.py:105, :145), so it is plain PyTorch on every
device here too.  The mesh geometry is NumPy (mesh/curvilinear.py); each
metric field goes to the device once, in the solver's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.basis import EAST, NORTH, SOUTH, WEST
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.physics.fluxes import get_flux
from dflo_tpu_torch.solver.spatial import (_check_bcs, segment_ghost,
                                           segmented_sides)


def make_rhs_curvilinear(basis: basis_mod.Basis, mesh, bcs: dict,
                         flux: str = "lxf", source=None, *,
                         dtype: torch.dtype, device):
    """du/dt = rhs(u, t) on a CurvilinearMesh (dflo_tpu/solver/
    spatial_curvi.py:37-188); bcs: {'W','E','S','N'} -> BoundarySide or
    SegmentedSide; source(x, y, t, W) an optional body force at the volume
    quadrature points.  ``rhs.cell_averages(u)`` gives the metric-weighted
    cell means."""
    num_flux = get_flux(flux)
    if not basis.is_nodal_collocated:
        raise ValueError("curvilinear blocks need the collocated Qk basis "
                         "(diagonal collocation mass, src/claw.cc:228-258)")
    per_x, per_y = _check_bcs(bcs)
    bcs, seg_sel = segmented_sides(bcs, mesh, device)

    def cast(a):
        return as_tensor(a, dtype, device)

    GxW = cast(basis.wq2[:, None] * basis.Gx)
    GyW = cast(basis.wq2[:, None] * basis.Gy)
    Vw = cast(basis.wq2[:, None] * basis.V)
    faceV = [cast(basis.faceV[f]) for f in range(4)]
    faceVw = [cast(basis.wq[:, None] * basis.faceV[f]) for f in range(4)]

    # volume metric fields at the (collocated) quadrature points
    QX, QY = np.meshgrid(basis.xq, basis.xq, indexing="xy")
    qpts = np.stack([QX.ravel(), QY.ravel()], axis=1)
    x_xi, x_eta, y_xi, y_eta, detJ = mesh.metric(qpts)
    if float(np.min(detJ)) <= 0.0:
        raise ValueError("mesh has inverted/degenerate cells (detJ <= 0)")
    x_xi, x_eta, y_xi, y_eta = (cast(a) for a in (x_xi, x_eta, y_xi, y_eta))
    detJc = cast(detJ)
    w2 = cast(basis.wq2)
    minv_field = 1.0 / (w2[:, None, None] * detJc)             # [K, ny, nx]
    wdet = w2[:, None, None] * detJc
    den = torch.sum(wdet, dim=0)

    # interface geometry
    enx_x, eny_x, L_x = (cast(a) for a in mesh.x_edges())      # [ny, nx+1]
    enx_y, eny_y, L_y = (cast(a) for a in mesh.y_edges())      # [ny+1, nx]

    def averages(u):
        """Metric-weighted cell means [4, ny, nx] (collocated: the DoFs are
        the quadrature values)."""
        return torch.sum(wdet[None] * u, dim=1) / den[None]

    # boundary-face coordinates for BC expressions
    face_xy = {}
    for name, side in (("W", WEST), ("E", EAST), ("S", SOUTH), ("N", NORTH)):
        xb, yb = mesh.face_coords(side, basis.xq)
        face_xy[name] = (cast(xb), cast(yb))

    # outward normals per boundary side (constant per edge)
    out_n = {"W": (-enx_x[:, 0], -eny_x[:, 0]),
             "E": (enx_x[:, -1], eny_x[:, -1]),
             "S": (-enx_y[0, :], -eny_y[0, :]),
             "N": (enx_y[-1, :], eny_y[-1, :])}

    if source is not None:
        xq2, yq2 = (cast(c) for c in mesh.point_coords(qpts))

    def boundary_flux(name, trace, ubar_b, t):
        """Outward flux [4, nq, n_along] on one side, each segment's ghost
        selected per cell."""
        nxo, nyo = (c[None, :] for c in out_n[name])
        xb, yb = face_xy[name]
        ghost = segment_ghost(bcs[name], seg_sel[name], nxo, nyo, trace, xb,
                              yb, t)
        A = ubar_b[:, None, :].expand_as(trace)
        return num_flux(trace, ghost, nxo, nyo, AL=A, AR=A)

    def lift(f, F):
        return basis_apply(faceVw[f].T, F)

    def rhs(u, t):
        """du/dt for u[4, K, ny, nx] at time t (plain torch)."""
        W = u                        # collocated: quadrature values = DoFs
        Fx = euler.flux_x(W)
        Fy = euler.flux_y(W)

        # volume: int F . grad(phi) dV with metric-contravariant weights
        C1 = Fx * y_eta[None] - Fy * x_eta[None]
        C2 = -Fx * y_xi[None] + Fy * x_xi[None]
        R = basis_apply(GxW.T, C1) + basis_apply(GyW.T, C2)
        if source is not None:
            S = source(xq2, yq2, t, W)
            R = R + basis_apply(Vw.T, S * detJc[None])

        ub = averages(u)
        uW = basis_apply(faceV[WEST], u)
        uE = basis_apply(faceV[EAST], u)
        uS = basis_apply(faceV[SOUTH], u)
        uN = basis_apply(faceV[NORTH], u)

        # ---- xi-interfaces ---------------------------------------------
        FL, FR = uE[..., :-1], uW[..., 1:]
        AL = ub[:, None, :, :-1].expand_as(FL)
        AR = ub[:, None, :, 1:].expand_as(FR)
        Fi = num_flux(FL, FR, enx_x[None, :, 1:-1], eny_x[None, :, 1:-1],
                      AL=AL, AR=AR)
        if per_x:
            Aw = ub[:, None, :, -1].expand_as(uE[..., -1])
            Ae = ub[:, None, :, 0].expand_as(uW[..., 0])
            Fw = num_flux(uE[..., -1], uW[..., 0], enx_x[None, :, 0],
                          eny_x[None, :, 0], AL=Aw, AR=Ae)
            Fe = Fw
        else:
            Fw = -boundary_flux("W", uW[..., 0], ub[..., 0], t)
            Fe = boundary_flux("E", uE[..., -1], ub[..., -1], t)
        Fx_all = torch.cat([Fw[..., None], Fi, Fe[..., None]], -1)
        Fx_all = Fx_all * L_x[None, None]
        R = R - lift(EAST, Fx_all[..., 1:])
        R = R + lift(WEST, Fx_all[..., :-1])

        # ---- eta-interfaces --------------------------------------------
        FL, FR = uN[..., :-1, :], uS[..., 1:, :]
        AL = ub[:, None, :-1, :].expand_as(FL)
        AR = ub[:, None, 1:, :].expand_as(FR)
        Fj = num_flux(FL, FR, enx_y[None, 1:-1, :], eny_y[None, 1:-1, :],
                      AL=AL, AR=AR)
        if per_y:
            As = ub[:, None, -1, :].expand_as(uN[..., -1, :])
            An = ub[:, None, 0, :].expand_as(uS[..., 0, :])
            Fs = num_flux(uN[..., -1, :], uS[..., 0, :], enx_y[None, 0, :],
                          eny_y[None, 0, :], AL=As, AR=An)
            Fn = Fs
        else:
            Fs = -boundary_flux("S", uS[..., 0, :], ub[..., 0, :], t)
            Fn = boundary_flux("N", uN[..., -1, :], ub[..., -1, :], t)
        Fy_all = torch.cat([Fs[..., None, :], Fj, Fn[..., None, :]], -2)
        Fy_all = Fy_all * L_y[None, None]
        R = R - lift(NORTH, Fy_all[..., 1:, :])
        R = R + lift(SOUTH, Fy_all[..., :-1, :])

        return R * minv_field[None]

    rhs.cell_averages = averages
    return rhs


def compute_dt_curvilinear(ubar, mesh, degree: int, cfl: float,
                           h_field=None):
    """Global CFL dt (0-dim tensor) on a curvilinear block
    (compute_time_step_q, src/claw.cc:520-557): min over the cells of
    cfl*h/max_eig/(2p+1), h = diameter/sqrt(dim) (mesh.cell_h, or
    h_field, a tensor on ubar's device)."""
    h = (as_tensor(mesh.cell_h(), ubar.dtype, ubar.device)
         if h_field is None else h_field)
    lam = euler.max_eigenvalue(ubar)
    return torch.amin(cfl * h / lam / (2.0 * degree + 1.0))
