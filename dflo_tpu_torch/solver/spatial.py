"""DG spatial residual: the plain torch residual and the O(boundary)
delta-flux strips that feed the fused residual kernel, on one device or on
a mesh of blocks.

The torch counterpart of dflo_tpu/solver/spatial.py for the Cartesian
path, on the collocated nodal Qk and GLL bases and the modal Pk basis,
optionally with a solid-cell mask (fluid-solid faces get slip-wall mirror
states and solid cells a zero residual) and a source term: a body force
(``source``, evaluated at the volume quadrature points) or well-balanced
gravity on a potential (``well_balanced``, isothermal or polytropic, on a
collocated basis).  The state is ``u[4, K, ny, nx]``;
the residual is du/dt = M^{-1} R(u, t) with the diagonal mass solve folded
in.  The fluxes get the cell averages of both cells (LxF's dissipation
speed and KEP's dissipation matrix read them; HLLC, Roe, Steger-Warming
and KFVS do not).  The fused form evaluates kfvs in its kernel form, with
the A&S erf, as the reference's kernel does; its strips and the plain
forms take torch's erf.

Three forms, selected by ``make_rhs(..., volume_kernel=...)`` as in the
reference:

- ``"xla"``: the whole-domain contraction form of the reference's rhs
  (dflo_tpu/solver/spatial.py:637), with true boundary fluxes from ghost
  states.  It is the plain reference the fused path is tested against.
- ``"pallas"``: the same, with the volume term computed by
  ``kernels.volume_residual`` (collocated bases only).
- ``"fused"``: ``kernels.fused_residual`` computes the periodic-wrap
  residual everywhere and adds the delta strips (true boundary flux minus
  wrap flux) at the domain edges.  The strips stay in torch: the boundary
  states come from user callables (the inflow expression), which cannot run
  inside a kernel.  The source rides the kernel's source arm: a
  ``euler.GravitySource`` or ``euler.ExternalForce`` (whose planes torch
  evaluates at each call's t) or isothermal well-balancing; any other
  source callable and polytropic well-balancing run on the plain forms
  only.  ``.stage`` gives the whole SSP stage
  ``a*u_old + (1-a)*(u + dt*R)`` in one kernel pass and ``.step`` the
  forward-Euler update ``u + dt*R``.  On the Pk basis ``.modal_ops`` holds
  the {truncation -> positivity} operators and, on an unmasked domain
  without a source term (the reference's sparse envelope,
  dflo_tpu/stab/mood.py:272-274, dflo_tpu/solver/spatial.py:498-499),
  ``.sparse_candidate`` is the MOOD cascade's candidate on a set of cells
  (``kernels.fused_mood_candidate``), with strips from the same
  {truncated -> positivity-limited} edge lines (``strips(u, t, deg)``).

With ``device_mesh`` (parallel/sharding) the state is a list of blocks and
only the fused form exists (dflo_tpu/solver/spatial.py:267-490, without its
source and MOOD-candidate arms, which raise): each block runs the residual
kernel on its own block, which wraps within the block, and its delta strips
carry the truth at all four borders: at an inner (or periodic) seam the flux
between its edge trace and the neighbor's, traced from the exchanged halo
line; at a true domain edge the boundary flux, its face coordinates sliced
at the block's offset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.basis import EAST, NORTH, SOUTH, WEST
from dflo_tpu_torch.ops.contract import (as_tensor, basis_apply,
                                         basis_apply1, basis_reduce)
from dflo_tpu_torch.parallel.sharding import block_shape, exchange_halos
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


@dataclasses.dataclass(frozen=True)
class SegmentedSide:
    """One domain side split into boundary-id segments along its length
    (dflo_tpu/solver/spatial.py:62-75): e.g. the double Mach reflection's
    bottom, post-shock Dirichlet before x = 1/6 and a slip wall after
    (examples/double_mach_reflection/grid.geo Physical Lines 0/1).
    ``seg_id[i]`` picks ``segments[seg_id[i]]`` for cell column (S, N) or
    row (W, E) i."""

    seg_id: np.ndarray
    segments: tuple

    @property
    def kind(self) -> int:
        # a segmented side is periodic only if its single segment is
        return (self.segments[0].kind
                if len(self.segments) == 1 else -999)


def _as_segmented(side, n_along: int) -> SegmentedSide:
    """A side as a SegmentedSide of n_along cells (a whole-side
    BoundarySide is one segment)."""
    if isinstance(side, SegmentedSide):
        if len(side.seg_id) != n_along:
            raise ValueError("seg_id length must equal the side's cell count")
        return side
    return SegmentedSide(np.zeros(n_along, np.int32), (side,))


#: outward unit normals per side
NORMALS = {"W": (-1.0, 0.0), "E": (1.0, 0.0), "S": (0.0, -1.0), "N": (0.0, 1.0)}


def _check_bcs(bcs) -> tuple[bool, bool]:
    """Validate the four sides (BoundarySide or SegmentedSide); returns
    (per_x, per_y)."""
    for name in ("W", "E", "S", "N"):
        side = bcs[name]
        segs = (side.segments if isinstance(side, SegmentedSide)
                else (side,))
        for seg in segs:
            if not isinstance(seg, BoundarySide):
                raise TypeError(f"side {name}: {seg!r} is not a "
                                f"BoundarySide")
            if seg.kind not in euler.SUPPORTED_BC:
                raise ValueError(f"side {name}: unknown boundary kind "
                                 f"{seg.kind}")
    per_x = bcs["W"].kind == euler.BC_PERIODIC
    per_y = bcs["S"].kind == euler.BC_PERIODIC
    if per_x != (bcs["E"].kind == euler.BC_PERIODIC):
        raise ValueError("periodic BC must pair W with E")
    if per_y != (bcs["N"].kind == euler.BC_PERIODIC):
        raise ValueError("periodic BC must pair S with N")
    return per_x, per_y


def segmented_sides(bcs, mesh, device):
    """(sides, planes): each of the four sides as a SegmentedSide of its
    cell count, and per side the bool plane [n_along] of each segment's
    cells (seg_id == si) on device."""
    sides = {n: _as_segmented(bcs[n], mesh.ny if n in "WE" else mesh.nx)
             for n in ("W", "E", "S", "N")}
    planes = {n: [torch.as_tensor(np.asarray(side.seg_id) == si,
                                  device=device)
                  for si in range(len(side.segments))]
              for n, side in sides.items()}
    return sides, planes


def segment_ghost(side: SegmentedSide, seg_sel, nrm_x, nrm_y, trace, xb, yb,
                  t):
    """The ghost state on a (segmented) side (dflo_tpu/solver/spatial.py:
    241-264): each segment's ghost from its kind and values at the face
    points (xb, yb), selected per cell by seg_sel[si] (bool [n_along] on
    the trace's device, seg_id == si).  A single segment is its own ghost,
    with no select.  A periodic segment of a split side copies the trace,
    as the reference's compute_wminus does for a kind it does not name."""
    ghost = None
    for si, seg in enumerate(side.segments):
        if seg.values is not None:
            bvals = torch.as_tensor(seg.values(xb, yb, t)).to(
                dtype=trace.dtype, device=trace.device).expand_as(trace)
        else:
            bvals = trace
        kind = (euler.BC_OUTFLOW if seg.kind == euler.BC_PERIODIC
                else seg.kind)
        g = euler.compute_wminus(kind, nrm_x, nrm_y, trace, bvals)
        ghost = g if ghost is None else torch.where(seg_sel[si][None, None],
                                                    g, ghost)
    return ghost


def make_rhs(basis: basis_mod.Basis, mesh, bcs: dict[str, BoundarySide],
             flux: str = "lxf", *, dtype: torch.dtype, device,
             volume_kernel: str = "xla", mask=None, source=None,
             well_balanced: str | None = None, potential=None,
             polytropic_nu: float = 1.2, mass_matrix: str = "diagonal",
             device_mesh=None):
    """Build du/dt = rhs(u, t) for a Cartesian mesh (see module docstring).

    bcs  : {'W','E','S','N'} -> BoundarySide; periodic sides come in opposite
           pairs.
    mask : optional bool [ny, nx], True = fluid cell.
    source : optional (x, y, t, W) -> [4, Q, ny, nx] body force at the volume
           quadrature points (src/equation.h:829-850, src_mpi/equation.h:
           1186-1202); the fused form takes euler.GravitySource and
           euler.ExternalForce.
    well_balanced : None | 'isothermal' | 'polytropic' with `potential`
           phi(x, y) (torch tensors in and out): the src_gll gravity source
           p/E grad_h(E) that keeps the hydrostatic equilibrium E to
           round-off (src_gll/assemble_explicit.cc:30-230); needs a
           collocated basis and excludes `source`.  Polytropic (exponent
           polytropic_nu) runs on the plain forms only, as in the reference.
    mass_matrix : 'diagonal' (lumped, src_gll/claw.cc:233-262) or 'full'
           (the consistent per-cell mass matrix, inverted exactly in float64
           once, src_gll/claw.cc:754-770, dflo_tpu/solver/spatial.py:183):
           the plain forms only, as the reference's kernel covers the
           diagonal mass alone.
    The fused form carries ``.strips(u, t)``, ``.stage(u, u_old, t, a, dt)``,
    ``.step(u, t, dt)``, ``.ops`` (the kernel operators) and
    ``.force(t)`` (the external force's planes at t, or None); the plain
    forms ``.lift_stack``, the [K, 2Q] volume lift [dy GxW^T | dx GyW^T].
    device_mesh: the sharded fused form over block lists
    (:func:`_make_rhs_sharded`); `device` is then unused.
    """
    collocated = basis.is_nodal_collocated
    if well_balanced is not None:
        # dflo_tpu/solver/spatial.py:187-229
        if well_balanced not in ("isothermal", "polytropic"):
            raise ValueError(f"unknown well-balanced form {well_balanced!r}")
        if source is not None:
            raise ValueError("source and well_balanced are mutually "
                             "exclusive (the force would be applied twice)")
        if not collocated:
            raise ValueError("well-balanced gravity needs a nodal-collocated "
                             "basis (GLL, src_gll/assemble_explicit.cc:66-72)")
        if potential is None:
            raise ValueError("well-balanced gravity needs a potential "
                             "phi(x, y)")
    if mass_matrix not in ("diagonal", "full"):
        raise ValueError(f"unknown mass matrix option {mass_matrix!r}")
    if volume_kernel == "fused" and mass_matrix != "diagonal":
        raise ValueError("volume_kernel='fused' covers the diagonal-mass "
                         "hot path (dflo_tpu/solver/spatial.py:191-194); use "
                         "'xla' or 'pallas' for the full mass matrix")
    if volume_kernel == "fused" and well_balanced == "polytropic":
        raise ValueError("volume_kernel='fused' carries no polytropic "
                         "well-balanced source; use 'xla' or 'pallas'")
    if device_mesh is not None:
        if volume_kernel != "fused" or mask is not None:
            raise NotImplementedError(
                "under a device mesh the port carries the fused residual on "
                "an unmasked domain; the plain forms and masks come with "
                "slice G, the rest of multi-GPU (ROADMAP)")
        if source is not None or well_balanced is not None:
            raise NotImplementedError(
                "a source term under a device mesh is not ported yet; it "
                "comes with slice G, the rest of multi-GPU (ROADMAP)")
        return _make_rhs_sharded(basis, mesh, bcs, flux, dtype, device_mesh)
    num_flux = get_flux(flux)
    per_x, per_y = _check_bcs(bcs)
    if volume_kernel not in ("xla", "pallas", "fused"):
        raise ValueError(f"unknown volume kernel {volume_kernel!r}")
    if volume_kernel == "pallas" and not collocated:
        raise ValueError("volume_kernel='pallas' needs a collocated basis "
                         "(the fully-fused kernel handles modal bases)")
    nq = basis.nq
    dx, dy = mesh.dx, mesh.dy

    def cast(a):
        return as_tensor(a, dtype, device)

    def as_time(t):
        """t as a 0-dim tensor of dtype (a float through a fill): the
        expressions of an external force take tensors."""
        if isinstance(t, torch.Tensor):
            return t.to(dtype=dtype)
        return torch.full((), float(t), dtype=dtype, device=device)

    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.shape != (mesh.ny, mesh.nx):
            raise ValueError(f"mask shape {mask.shape} != (ny, nx)")
        fmask = cast(mask)

        def flags(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        # interior-interface wall flags (a mirror flux where True)
        wallx_L = flags(~mask[:, :-1] & mask[:, 1:])    # solid | fluid
        wallx_R = flags(mask[:, :-1] & ~mask[:, 1:])    # fluid | solid
        wally_L = flags(~mask[:-1, :] & mask[1:, :])
        wally_R = flags(mask[:-1, :] & ~mask[1:, :])
        # the fluid flags of the cells on either side of the wrap faces
        walls_x = flags(mask[:, -1]), flags(mask[:, 0])
        walls_y = flags(mask[-1, :]), flags(mask[0, :])
    else:
        walls_x = walls_y = None

    V = cast(basis.V)
    GxW = cast(basis.wq2[:, None] * basis.Gx)
    GyW = cast(basis.wq2[:, None] * basis.Gy)
    faceV = [cast(basis.faceV[f]) for f in range(4)]
    faceVw = [cast(basis.wq[:, None] * basis.faceV[f]) for f in range(4)]
    avg_op = cast(basis.wq2 @ basis.V)
    lift_stack = torch.cat([dy * GxW.T, dx * GyW.T], dim=1).contiguous()
    if volume_kernel == "pallas":
        # the kernel reads the lift's tensor-product entries alone: check
        # the host copy once (its zeros are the cast tensor's zeros)
        kernels.check_volume_lift(basis, np.concatenate(
            [dy * (basis.wq2[:, None] * basis.Gx).T,
             dx * (basis.wq2[:, None] * basis.Gy).T], axis=1))
    minv = cast(1.0 / basis.mass)
    # the full mass matrix inverted in float64, then cast (as the reference)
    minv_full = (cast(np.linalg.inv(basis.mass_full))
                 if mass_matrix == "full" else None)
    area = dx * dy

    # boundary face quadrature coordinates (for BC expressions)
    face_xy = {}
    for name, side in (("W", WEST), ("E", EAST), ("S", SOUTH), ("N", NORTH)):
        xb, yb = mesh.face_coords(side, basis.xq)
        face_xy[name] = (cast(xb), cast(yb))

    bcs, seg_sel = segmented_sides(bcs, mesh, device)

    def boundary_flux(name: str, trace, ubar_b, t, off: int = 0):
        """Outward numerical flux on one domain side.

        trace  : [4, nq, n_along] inside trace
        ubar_b : [4, n_along] boundary-cell averages
        off    : the first cell of the side's stretch (a block's offset
                 along it; the JAX path's _bflux_local slices its face
                 coordinates and segment ids there)
        Returns [4, nq, n_along], w.r.t. the OUTWARD normal."""
        nrm_x, nrm_y = NORMALS[name]
        n_along = trace.shape[-1]
        xb, yb = (c[:, off:off + n_along] for c in face_xy[name])
        sel = [m[off:off + n_along] for m in seg_sel[name]]
        ghost = segment_ghost(bcs[name], sel, nrm_x, nrm_y, trace, xb, yb, t)
        A = ubar_b[:, None, :].expand_as(trace)
        return num_flux(trace, ghost, nrm_x, nrm_y, AL=A, AR=A)

    modal = basis.family == "Pk"
    fused = volume_kernel == "fused"
    mops = (kernels.modal_operators(basis, mesh, dtype=dtype, device=device)
            if fused and modal else None)

    def strips(u, t, deg=None, halos=None, off=(0, 0)):
        """O(boundary) delta-flux strips (dflo_tpu/solver/spatial.py:525):
        the true boundary flux minus the periodic-wrap flux the kernel
        computes at the domain edges, with the kernel's slip-wall mirror at
        a fluid|solid wrap face.  Returns (dfw, dfe [4, nq, ny], dfs, dfn
        [4, nq, nx]); zero on periodic sides.  deg (Pk, the MOOD candidate):
        the edge DoF lines are {truncated -> positivity-limited} first
        (kernels.modal_tp_plain, tp_line of pallas_kernels.py:933-943), so
        the strips see the u_t the kernel traces.

        Block form (u one block of a meshed state, dflo_tpu/solver/
        spatial.py:333-418): halos = (hW, hE, hS, hN), the neighbors' edge
        DoF lines (parallel/sharding.exchange_halos); off = (oy, ox), the
        block's first cell.  The true flux at a side is the seam flux with
        the neighbor's trace where its halo is given (a periodic seam
        included), else the boundary flux on the side's stretch."""
        ny_, nx_ = u.shape[-2:]
        hW, hE, hS, hN = (None,) * 4 if halos is None else halos
        oy, ox = off

        def edge(idx):
            """The edge DoF line u[:, :, *idx], tp'd with deg[idx] when
            deg is given."""
            line = u[(slice(None), slice(None)) + idx]
            if deg is None:
                return line
            return kernels.modal_tp_plain(line, deg[idx], mops)

        def wrap_flux(uL, uR, aL, aR, walls, mirror, nrm):
            """The flux the kernel computes at the wrap faces; walls: the
            fluid flags (left, right) of the wrap's cells, or None."""
            AL = aL[:, None].expand_as(uL)
            AR = aR[:, None].expand_as(uR)
            if walls is not None:
                uL, uR, AL, AR = euler.wall_fix(uL, uR, AL, AR, *walls, mirror)
            return num_flux(uL, uR, *nrm, AL=AL, AR=AR)

        def seam(uL, uR, aL, aR, nrm):
            """The flux across a seam between two blocks' edge traces."""
            return num_flux(uL, uR, *nrm, AL=aL[:, None].expand_as(uL),
                            AR=aR[:, None].expand_as(uR))

        if per_x and halos is None:
            dfw = dfe = u.new_zeros((4, nq, ny_))
        else:
            c0, cl = edge((slice(None), 0)), edge((slice(None), -1))
            uW0 = torch.einsum("qk,cky->cqy", faceV[WEST], c0)
            uEl = torch.einsum("qk,cky->cqy", faceV[EAST], cl)
            ub0 = torch.einsum("k,cky->cy", avg_op, c0)
            ubl = torch.einsum("k,cky->cy", avg_op, cl)
            Fwrap = wrap_flux(uEl, uW0, ubl, ub0, walls_x, euler.mirror_x,
                              (1.0, 0.0))
            dfw = (seam(torch.einsum("qk,cky->cqy", faceV[EAST], hW), uW0,
                        torch.einsum("k,cky->cy", avg_op, hW), ub0,
                        (1.0, 0.0)) if hW is not None
                   else -boundary_flux("W", uW0, ub0, t, oy)) - Fwrap
            dfe = (seam(uEl, torch.einsum("qk,cky->cqy", faceV[WEST], hE),
                        ubl, torch.einsum("k,cky->cy", avg_op, hE),
                        (1.0, 0.0)) if hE is not None
                   else boundary_flux("E", uEl, ubl, t, oy)) - Fwrap
        if per_y and halos is None:
            dfs = dfn = u.new_zeros((4, nq, nx_))
        else:
            r0, rl = edge((0,)), edge((-1,))
            uS0 = torch.einsum("qk,ckx->cqx", faceV[SOUTH], r0)
            uNl = torch.einsum("qk,ckx->cqx", faceV[NORTH], rl)
            ub0 = torch.einsum("k,ckx->cx", avg_op, r0)
            ubl = torch.einsum("k,ckx->cx", avg_op, rl)
            Fwrap = wrap_flux(uNl, uS0, ubl, ub0, walls_y, euler.mirror_y,
                              (0.0, 1.0))
            dfs = (seam(torch.einsum("qk,ckx->cqx", faceV[NORTH], hS), uS0,
                        torch.einsum("k,ckx->cx", avg_op, hS), ub0,
                        (0.0, 1.0)) if hS is not None
                   else -boundary_flux("S", uS0, ub0, t, ox)) - Fwrap
            dfn = (seam(uNl, torch.einsum("qk,ckx->cqx", faceV[SOUTH], hN),
                        ubl, torch.einsum("k,ckx->cx", avg_op, hN),
                        (0.0, 1.0)) if hN is not None
                   else boundary_flux("N", uNl, ubl, t, ox)) - Fwrap
        return (dfw.contiguous(), dfe.contiguous(), dfs.contiguous(),
                dfn.contiguous())

    if fused:
        ops = kernels.residual_operators(
            basis, mesh, flux=flux, mask=mask, source=source,
            well_balanced=well_balanced, potential=potential, dtype=dtype,
            device=device)

        def force(t):
            """The external force's planes at t (ops.source "force"), else
            None."""
            if ops.source != "force":
                return None
            return kernels.force_planes(ops, as_time(t))

        def rhs_fused(u, t):
            """du/dt through the fused residual kernel."""
            return kernels.fused_residual(u, *strips(u, t), ops,
                                          force=force(t))

        def stage_fused(u, u_old, t, a, dt):
            """a*u_old + (1-a)*(u + dt*du/dt) in one kernel pass; a is a
            Python float, dt a 0-dim tensor on u's device (no host sync)."""
            dt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
            sc = torch.stack([torch.full_like(dt, a), dt])
            return kernels.fused_residual(u, *strips(u, t), ops,
                                          u_old=u_old, sc=sc, force=force(t))

        def step_fused(u, t, dt):
            """u + dt*du/dt in one kernel pass (dt a 0-dim tensor on u's
            device): the MOOD cascade's first candidate."""
            return kernels.fused_residual(u, *strips(u, t), ops, dt=dt,
                                          force=force(t))

        rhs_fused.stage = stage_fused
        rhs_fused.step = step_fused
        rhs_fused.strips = strips
        rhs_fused.ops = ops
        rhs_fused.force = force
        if modal:
            rhs_fused.modal_ops = mops
        if modal and ops.source is None and mask is None:
            def sparse_candidate(u, u_prev, deg, t, dt, cells):
                """The MOOD candidate u_t + dt*R(u_t), u_t = {truncation to
                deg -> positivity}(u), on the cells set in the bool plane
                `cells`, written into u_prev; other cells keep u_prev
                (dflo_tpu/solver/spatial.py:621-632)."""
                return kernels.fused_mood_candidate(
                    u, u_prev, deg, cells, *strips(u, t, deg), ops, mops, dt)

            rhs_fused.sparse_candidate = sparse_candidate
        return rhs_fused

    if source is not None or well_balanced is not None:
        # the source's points (the nodes of a collocated basis), and its
        # projection Vw^T
        xq2, yq2 = (cast(c) for c in kernels.nodal_points(basis, mesh))
        Vw = cast(basis.wq2[:, None] * basis.V)
    if well_balanced is not None:
        phi = torch.as_tensor(potential(xq2, yq2)).to(dtype=dtype,
                                                      device=device)
        Gxn, Gyn = cast(basis.Gx), cast(basis.Gy)      # nodal derivatives

    def source_term(u, W, ub, t):
        """area * Vw^T S of the body force or the well-balanced source
        (dflo_tpu/solver/spatial.py:662-692)."""
        if source is not None:
            S = source(xq2, yq2, as_time(t), W)
        elif well_balanced == "isothermal":
            # src_gll/assemble_explicit.cc:30-135: S_m = (rho RT / E)
            # grad_h E with E = exp(-phi/RT), RT from the cell average
            RT = euler.pressure(ub) / ub[euler.RHO]
            E = torch.exp(-phi / RT[None])
            fac = W[euler.RHO] * RT[None] / E
            S = euler.well_balanced_source(
                W, fac, basis_apply1(Gxn, E) / dx, basis_apply1(Gyn, E) / dy)
        else:
            # polytropic, src_gll/assemble_explicit.cc:138-230
            nu = polytropic_nu
            pq = euler.pressure(W)
            ff = nu / (nu - 1.0) * pq / W[euler.RHO] + phi
            beta, qstar = torch.max(ff, dim=0)
            alpha_q = pq / W[euler.RHO] ** nu
            alpha = torch.gather(alpha_q, 0, qstar[None])[0]
            E = ((nu - 1.0) * (beta[None] - phi)
                 / (nu * alpha[None])) ** (nu / (nu - 1.0))
            fac = (nu - 1.0) / nu * W[euler.RHO] * (beta[None] - phi) / E
            S = euler.well_balanced_source(
                W, fac, basis_apply1(Gxn, E) / dx, basis_apply1(Gyn, E) / dy)
        return area * basis_apply(Vw.T, S)

    def rhs(u, t):
        """du/dt for u[4, K, ny, nx] at time t (plain torch; with
        volume_kernel='pallas' the volume term through its kernel)."""
        W = u if collocated else basis_apply(V, u)
        uW = basis_apply(faceV[WEST], u)
        uE = basis_apply(faceV[EAST], u)
        uS = basis_apply(faceV[SOUTH], u)
        uN = basis_apply(faceV[NORTH], u)
        ub = basis_reduce(avg_op, u)                  # [4, ny, nx]

        # ---- volume term: + int F . grad(phi) dV -------------------------
        if volume_kernel == "pallas":
            R = kernels.volume_residual(lift_stack, u)
        else:
            R = basis_apply(lift_stack, torch.cat([euler.flux_x(W),
                                                   euler.flux_y(W)], dim=1))
        if source is not None or well_balanced is not None:
            R = R + source_term(u, W, ub, t)

        # ---- x-direction interfaces (normal +x), nx+1 slots ---------------
        FL, FR = uE[..., :-1], uW[..., 1:]
        AL = ub[:, None, :, :-1].expand_as(FL)
        AR = ub[:, None, :, 1:].expand_as(FR)
        if mask is not None:
            # slip-wall mirror states at fluid-solid interfaces
            w = wallx_L[None, None]
            FL, AL = (torch.where(w, euler.mirror_x(FR), FL),
                      torch.where(w, euler.mirror_x(AR), AL))
            w = wallx_R[None, None]
            FR, AR = (torch.where(w, euler.mirror_x(uE[..., :-1]), FR),
                      torch.where(w, euler.mirror_x(
                          ub[:, None, :, :-1].expand_as(FL)), AR))
        Fi = num_flux(FL, FR, 1.0, 0.0, AL=AL, AR=AR)
        if per_x:
            Aw = ub[:, None, :, -1].expand_as(uE[..., -1])
            Ae = ub[:, None, :, 0].expand_as(uW[..., 0])
            Fwrap = num_flux(uE[..., -1], uW[..., 0], 1.0, 0.0, AL=Aw, AR=Ae)
            Fx_all = torch.cat([Fwrap[..., None], Fi, Fwrap[..., None]], -1)
        else:
            # outward boundary fluxes sign-flipped into the +x orientation
            # (conservative fluxes satisfy F(a,b,n) = -F(b,a,-n))
            Fw = -boundary_flux("W", uW[..., 0], ub[..., 0], t)
            Fe = boundary_flux("E", uE[..., -1], ub[..., -1], t)
            Fx_all = torch.cat([Fw[..., None], Fi, Fe[..., None]], -1)
        R = R - dy * basis_apply(faceVw[EAST].T, Fx_all[..., 1:])
        R = R + dy * basis_apply(faceVw[WEST].T, Fx_all[..., :-1])

        # ---- y-direction interfaces (normal +y), ny+1 slots ---------------
        FL, FR = uN[..., :-1, :], uS[..., 1:, :]
        AL = ub[:, None, :-1, :].expand_as(FL)
        AR = ub[:, None, 1:, :].expand_as(FR)
        if mask is not None:
            w = wally_L[None, None]
            FL, AL = (torch.where(w, euler.mirror_y(FR), FL),
                      torch.where(w, euler.mirror_y(AR), AL))
            w = wally_R[None, None]
            FR, AR = (torch.where(w, euler.mirror_y(uN[..., :-1, :]), FR),
                      torch.where(w, euler.mirror_y(
                          ub[:, None, :-1, :].expand_as(FL)), AR))
        Fj = num_flux(FL, FR, 0.0, 1.0, AL=AL, AR=AR)
        if per_y:
            As = ub[:, None, -1, :].expand_as(uN[..., -1, :])
            An = ub[:, None, 0, :].expand_as(uS[..., 0, :])
            Fwrap = num_flux(uN[..., -1, :], uS[..., 0, :], 0.0, 1.0, AL=As,
                             AR=An)
            Fy_all = torch.cat([Fwrap[..., None, :], Fj, Fwrap[..., None, :]],
                               -2)
        else:
            Fs = -boundary_flux("S", uS[..., 0, :], ub[..., 0, :], t)
            Fn = boundary_flux("N", uN[..., -1, :], ub[..., -1, :], t)
            Fy_all = torch.cat([Fs[..., None, :], Fj, Fn[..., None, :]], -2)
        R = R - dx * basis_apply(faceVw[NORTH].T, Fy_all[..., 1:, :])
        R = R + dx * basis_apply(faceVw[SOUTH].T, Fy_all[..., :-1, :])

        # ---- mass solve (src/claw.cc:694-713; full: src_gll/claw.cc:754) --
        if minv_full is not None:
            R = basis_apply(minv_full, R) / area
        else:
            R = R * (minv[None, :, None, None] / area)
        if mask is not None:
            R = R * fmask[None, None]                 # solid cells are frozen
        return R

    rhs.lift_stack = lift_stack
    return rhs


def _make_rhs_sharded(basis, mesh, bcs, flux, dtype, dm):
    """The fused residual over the block list of a state split on dm.

    One single-device fused rhs per distinct device holds the operators
    there; each block runs ``kernels.fused_residual``, which wraps within
    the block, with the strips of its halo lines and offset, which carry
    the truth at all four of its borders.  The returned rhs(blocks, t) and
    ``.stage(blocks, u_old, t, a, dt)`` take and return block lists, with
    t, dt 0-dim tensors (or Python floats); ``.strips(blocks, t)`` gives
    every block's four strips."""
    per_x, per_y = _check_bcs(bcs)
    ly, lx = block_shape(dm, mesh.ny, mesh.nx)
    local = {}
    for dev in dm.flat:
        if dev not in local:
            local[dev] = make_rhs(basis, mesh, bcs, flux, dtype=dtype,
                                  device=dev, volume_kernel="fused")
    DX = dm.shape[1]
    offs = [(k // DX * ly, k % DX * lx) for k in range(len(dm.flat))]

    def on(x, dev):
        return x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor) \
            else x

    def strips(blocks, t):
        halos = exchange_halos(blocks, dm, per_x, per_y)
        return [local[dev].strips(u, on(t, dev), halos=h, off=o)
                for u, h, o, dev in zip(blocks, halos, offs, dm.flat)]

    def rhs_sharded(blocks, t):
        """du/dt of every block through the fused residual kernel."""
        return [kernels.fused_residual(u, *st, local[dev].ops)
                for u, st, dev in zip(blocks, strips(blocks, t), dm.flat)]

    def stage_sharded(blocks, u_old, t, a, dt):
        """a*u_old + (1-a)*(u + dt*du/dt) of every block in one kernel pass
        each (dt a 0-dim tensor; no host sync)."""
        out = []
        for u, uo, st, dev in zip(blocks, u_old, strips(blocks, t), dm.flat):
            dtt = torch.as_tensor(dt, dtype=u.dtype).to(u.device,
                                                       non_blocking=True)
            sc = torch.stack([torch.full_like(dtt, a), dtt])
            out.append(kernels.fused_residual(u, *st, local[dev].ops,
                                              u_old=uo, sc=sc))
        return out

    rhs_sharded.stage = stage_sharded
    rhs_sharded.strips = strips
    return rhs_sharded


def cell_averages(basis: basis_mod.Basis, u):
    """Mean conserved state per cell: [4, K, ny, nx] -> [4, ny, nx]
    (src/claw.cc:562-597)."""
    return basis_reduce(as_tensor(basis.wq2 @ basis.V, u.dtype, u.device), u)

