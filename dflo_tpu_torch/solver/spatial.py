"""DG spatial residual on one device: the plain torch residual and the
O(boundary) delta-flux strips that feed the fused residual kernel.

The torch counterpart of dflo_tpu/solver/spatial.py for the unmasked,
single-device Cartesian path, on the collocated nodal Qk basis and the modal
Pk basis.  The state is ``u[4, K, ny, nx]``; the residual is
du/dt = M^{-1} R(u, t) with the diagonal mass solve folded in.

Two forms, selected by ``make_rhs(..., fused=...)``:

- plain (``fused=False``): the whole-domain contraction form of the
  reference's rhs (dflo_tpu/solver/spatial.py:637), with true boundary fluxes
  from ghost states.  It is the plain reference the fused path is tested
  against.
- fused (``fused=True``): ``dflo_tpu_torch.ops.kernels.fused_residual``
  computes the periodic-wrap residual everywhere and adds the delta strips
  (true boundary flux minus wrap flux) at the domain edges.  The strips stay
  in torch: the boundary states come from user callables (the inflow lambda),
  which cannot run inside a kernel.  ``.stage`` gives the whole SSP stage
  ``a*u_old + (1-a)*(u + dt*R)`` in one kernel pass and ``.step`` the
  forward-Euler update ``u + dt*R``.  On the Pk basis ``.sparse_candidate``
  is the MOOD cascade's candidate on a set of cells
  (``kernels.fused_mood_candidate``), with strips from the same
  {truncated -> positivity-limited} edge lines (``strips(u, t, deg)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import EAST, NORTH, SOUTH, WEST
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply, basis_reduce
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.physics.fluxes import get_flux


@dataclasses.dataclass(frozen=True)
class BoundarySide:
    """BC for one side of a Cartesian domain.

    kind   : euler.BC_* code (src/equation.h:862-869).
    values : callable (x, y, t) -> [4, ...] boundary expression values in the
             conserved layout (torch tensors in, torch tensor out); None for
             kinds that need no data.
    """

    kind: int
    values: Callable | None = None


#: outward unit normals per side
NORMALS = {"W": (-1.0, 0.0), "E": (1.0, 0.0), "S": (0.0, -1.0), "N": (0.0, 1.0)}


def _check_bcs(bcs) -> tuple[bool, bool]:
    """Validate the four sides; returns (per_x, per_y)."""
    for name in ("W", "E", "S", "N"):
        side = bcs[name]
        if not isinstance(side, BoundarySide):
            raise NotImplementedError(
                f"side {name}: only whole-side BoundarySide BCs are ported "
                f"(segmented sides come with the physics envelope slice)")
        if side.kind not in euler.SUPPORTED_BC:
            raise NotImplementedError(
                f"side {name}: boundary kind {side.kind} is not ported yet")
    per_x = bcs["W"].kind == euler.BC_PERIODIC
    per_y = bcs["S"].kind == euler.BC_PERIODIC
    if per_x != (bcs["E"].kind == euler.BC_PERIODIC):
        raise ValueError("periodic BC must pair W with E")
    if per_y != (bcs["N"].kind == euler.BC_PERIODIC):
        raise ValueError("periodic BC must pair S with N")
    return per_x, per_y


def make_rhs(basis: basis_mod.Basis, mesh, bcs: dict[str, BoundarySide],
             flux: str = "hllc", *, dtype: torch.dtype, device,
             fused: bool = False):
    """Build du/dt = rhs(u, t) for a Cartesian mesh (see module docstring).

    bcs : {'W','E','S','N'} -> BoundarySide; periodic sides come in opposite
          pairs.  The fused form carries ``.strips(u, t)``,
          ``.stage(u, u_old, t, a, dt)`` and ``.ops`` (the kernel operators).
    """
    num_flux = get_flux(flux)
    per_x, per_y = _check_bcs(bcs)
    collocated = basis.is_nodal_collocated
    nq = basis.nq
    dx, dy = mesh.dx, mesh.dy

    def cast(a):
        return as_tensor(a, dtype, device)

    V = cast(basis.V)
    GxW = cast(basis.wq2[:, None] * basis.Gx)
    GyW = cast(basis.wq2[:, None] * basis.Gy)
    faceV = [cast(basis.faceV[f]) for f in range(4)]
    faceVw = [cast(basis.wq[:, None] * basis.faceV[f]) for f in range(4)]
    lift_stack = torch.cat([dy * GxW.T, dx * GyW.T], dim=1)      # [K, 2Q]
    minv = cast(1.0 / basis.mass)
    area = dx * dy

    # boundary face quadrature coordinates (for BC expressions)
    face_xy = {}
    for name, side in (("W", WEST), ("E", EAST), ("S", SOUTH), ("N", NORTH)):
        xb, yb = mesh.face_coords(side, basis.xq)
        face_xy[name] = (cast(xb), cast(yb))

    def boundary_flux(name: str, trace, t):
        """Outward numerical flux on one domain side.

        trace  : [4, nq, n_along] inside trace
        Returns [4, nq, n_along], w.r.t. the OUTWARD normal.  (HLLC reads no
        cell averages; the reference's AL/AR arguments come back with the
        fluxes that do, in the physics envelope slice.)"""
        side = bcs[name]
        nrm_x, nrm_y = NORMALS[name]
        if side.values is not None:
            xb, yb = face_xy[name]
            bvals = torch.as_tensor(side.values(xb, yb, t)).to(
                dtype=trace.dtype, device=trace.device).expand_as(trace)
        else:
            bvals = trace
        ghost = euler.compute_wminus(side.kind, nrm_x, nrm_y, trace, bvals)
        return num_flux(trace, ghost, nrm_x, nrm_y)

    modal = basis.family == "Pk"
    mops = (kernels.modal_operators(basis, mesh, dtype=dtype, device=device)
            if fused and modal else None)

    def strips(u, t, deg=None):
        """O(boundary) delta-flux strips (dflo_tpu/solver/spatial.py:525):
        the true boundary flux minus the periodic-wrap flux the kernel
        computes at the domain edges.  Returns (dfw, dfe [4, nq, ny],
        dfs, dfn [4, nq, nx]); zero on periodic sides.  deg (Pk, the MOOD
        candidate): the edge DoF lines are {truncated -> positivity-limited}
        first (kernels.modal_tp_plain, tp_line of pallas_kernels.py:
        933-943), so the strips see the u_t the kernel traces."""
        ny_, nx_ = u.shape[-2:]

        def edge(idx):
            """The edge DoF line u[:, :, *idx], tp'd with deg[idx] when
            deg is given."""
            line = u[(slice(None), slice(None)) + idx]
            if deg is None:
                return line
            return kernels.modal_tp_plain(line, deg[idx], mops)

        if per_x:
            dfw = dfe = u.new_zeros((4, nq, ny_))
        else:
            c0, cl = edge((slice(None), 0)), edge((slice(None), -1))
            uW0 = torch.einsum("qk,cky->cqy", faceV[WEST], c0)
            uEl = torch.einsum("qk,cky->cqy", faceV[EAST], cl)
            Fwrap = num_flux(uEl, uW0, 1.0, 0.0)
            dfw = -boundary_flux("W", uW0, t) - Fwrap
            dfe = boundary_flux("E", uEl, t) - Fwrap
        if per_y:
            dfs = dfn = u.new_zeros((4, nq, nx_))
        else:
            r0, rl = edge((0,)), edge((-1,))
            uS0 = torch.einsum("qk,ckx->cqx", faceV[SOUTH], r0)
            uNl = torch.einsum("qk,ckx->cqx", faceV[NORTH], rl)
            Fwrap = num_flux(uNl, uS0, 0.0, 1.0)
            dfs = -boundary_flux("S", uS0, t) - Fwrap
            dfn = boundary_flux("N", uNl, t) - Fwrap
        return (dfw.contiguous(), dfe.contiguous(), dfs.contiguous(),
                dfn.contiguous())

    if fused:
        if flux != "hllc":
            raise NotImplementedError("the fused residual kernel carries hllc")
        ops = kernels.residual_operators(basis, mesh, dtype=dtype,
                                         device=device)

        def rhs_fused(u, t):
            """du/dt through the fused residual kernel."""
            return kernels.fused_residual(u, *strips(u, t), ops)

        def stage_fused(u, u_old, t, a, dt):
            """a*u_old + (1-a)*(u + dt*du/dt) in one kernel pass; a is a
            Python float, dt a 0-dim tensor on u's device (no host sync)."""
            dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
            sc = torch.stack([torch.full_like(dt, a), dt])
            return kernels.fused_residual(u, *strips(u, t), ops,
                                          u_old=u_old, sc=sc)

        def step_fused(u, t, dt):
            """u + dt*du/dt in one kernel pass (dt a 0-dim tensor on u's
            device): the MOOD cascade's first candidate."""
            return kernels.fused_residual(u, *strips(u, t), ops, dt=dt)

        rhs_fused.stage = stage_fused
        rhs_fused.step = step_fused
        rhs_fused.strips = strips
        rhs_fused.ops = ops
        if modal:
            def sparse_candidate(u, u_prev, deg, t, dt, cells):
                """The MOOD candidate u_t + dt*R(u_t), u_t = {truncation to
                deg -> positivity}(u), on the cells set in the bool plane
                `cells`, written into u_prev; other cells keep u_prev
                (dflo_tpu/solver/spatial.py:621-632)."""
                return kernels.fused_mood_candidate(
                    u, u_prev, deg, cells, *strips(u, t, deg), ops, mops, dt)

            rhs_fused.sparse_candidate = sparse_candidate
            rhs_fused.modal_ops = mops
        return rhs_fused

    def rhs(u, t):
        """du/dt for u[4, K, ny, nx] at time t (plain torch)."""
        W = u if collocated else basis_apply(V, u)
        Fx = euler.flux_x(W)
        Fy = euler.flux_y(W)
        uW = basis_apply(faceV[WEST], u)
        uE = basis_apply(faceV[EAST], u)
        uS = basis_apply(faceV[SOUTH], u)
        uN = basis_apply(faceV[NORTH], u)

        # ---- volume term: + int F . grad(phi) dV -------------------------
        R = basis_apply(lift_stack, torch.cat([Fx, Fy], dim=1))

        # ---- x-direction interfaces (normal +x), nx+1 slots ---------------
        Fi = num_flux(uE[..., :-1], uW[..., 1:], 1.0, 0.0)
        if per_x:
            Fwrap = num_flux(uE[..., -1], uW[..., 0], 1.0, 0.0)
            Fx_all = torch.cat([Fwrap[..., None], Fi, Fwrap[..., None]], -1)
        else:
            # outward boundary fluxes sign-flipped into the +x orientation
            # (conservative fluxes satisfy F(a,b,n) = -F(b,a,-n))
            Fw = -boundary_flux("W", uW[..., 0], t)
            Fe = boundary_flux("E", uE[..., -1], t)
            Fx_all = torch.cat([Fw[..., None], Fi, Fe[..., None]], -1)
        R = R - dy * basis_apply(faceVw[EAST].T, Fx_all[..., 1:])
        R = R + dy * basis_apply(faceVw[WEST].T, Fx_all[..., :-1])

        # ---- y-direction interfaces (normal +y), ny+1 slots ---------------
        Fj = num_flux(uN[..., :-1, :], uS[..., 1:, :], 0.0, 1.0)
        if per_y:
            Fwrap = num_flux(uN[..., -1, :], uS[..., 0, :], 0.0, 1.0)
            Fy_all = torch.cat([Fwrap[..., None, :], Fj, Fwrap[..., None, :]],
                               -2)
        else:
            Fs = -boundary_flux("S", uS[..., 0, :], t)
            Fn = boundary_flux("N", uN[..., -1, :], t)
            Fy_all = torch.cat([Fs[..., None, :], Fj, Fn[..., None, :]], -2)
        R = R - dx * basis_apply(faceVw[NORTH].T, Fy_all[..., 1:, :])
        R = R + dx * basis_apply(faceVw[SOUTH].T, Fy_all[..., :-1, :])

        # ---- diagonal mass solve (src/claw.cc:694-713) -------------------
        return R * (minv[None, :, None, None] / area)

    return rhs


def cell_averages(basis: basis_mod.Basis, u):
    """Mean conserved state per cell: [4, K, ny, nx] -> [4, ny, nx]
    (src/claw.cc:562-597)."""
    return basis_reduce(as_tensor(basis.wq2 @ basis.V, u.dtype, u.device), u)

