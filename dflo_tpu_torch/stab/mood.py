"""MOOD a posteriori stabilization on the modal Pk basis.

The torch counterpart of dflo_tpu/stab/mood.py (the reference's MOOD
cascade, src/mood.cc:1-491; driver iterate_mood, src/claw.cc:777-871), in
the form the JAX package runs on the TPU: pass 1 peeled out of the loop
(the forward-Euler update of the unmodified stage predictor), then a fixed
point in which every pass recomputes the candidate only on the cells whose
candidate can change (the sparse re-update of src/claw.cc:806-852), each
pass ending in the acceptance check.

Which cells can change: a cell whose degree changed, or a face neighbor of
one in the kernel's periodic-wrap stencil (on a side that is not periodic
the edge cells' candidates still take their delta strips' wrap flux, which
reads the opposite edge: it cancels the kernel's only up to rounding, and
with kfvs only up to its kernel-form erf), and -- unlike the JAX package's
TPU path -- every cell where applying the {truncation -> positivity} chain
to the predictor at full degree is not the identity, with its face
neighbors.  Zhang-Shu positivity is not idempotent: on a cell it limited
to the pressure floor, a second application can take the reference's
round-off branch (|1 - t| < 1e-14 -> t = 0) and flatten the cell to its
mean.  The dense cascade (and the JAX package's CPU
path) re-applies it to every cell from pass 2 on; a sparse pass that skips
such a cell keeps its pass-1 value and disagrees.  Recomputing those cells
too makes the sparse cascade equal to the dense one, whatever the tiles.

Per check (apply_mood, src/mood.cc:290-400):
- DMP on the candidate's density mean against the neighborhood min/max of
  the predictor's means (+-1e-6, src/mood.cc:314-317);
- Diot's u2 smoothness exemption on the density D2 modes (src/mood.cc:
  233-282, eps = 0.5);
- failing cells with degree > 1 drop one degree; failing degree-1 cells
  switch on the TVB limiter; failing degree-1 cells already marked spread
  the reduction to their face neighbors, without wrapping at edges that
  are not periodic (src/mood.cc:335-394).

The fixed point runs on the host, one ``bool(chg.any())`` per pass (up to
``max_iters``); everything else stays on the device.  MOOD requires the Pk
basis and global time stepping (src/parameters.cc:536-544).

Three routes, as the reference's make_mood: with the fused modal residual
and positivity on (the reference's fused {truncation -> positivity}
kernel, dflo_tpu/stab/mood.py:262, driver.py:283-285), the sparse route
above where the residual carries the one-pass candidate (an unmasked domain
without a source term), else the dense route, every pass after the first
the {truncation -> positivity} kernel on the predictor followed by the
forward-Euler residual on every cell (dflo_tpu/stab/mood.py:320-332).
Otherwise (the plain residual, a source callable the kernel does not carry,
or positivity off) the plain arm: each pass's candidate is the truncated
predictor, re-limited by the plain Zhang-Shu limiter about the predictor's
averages when positivity is on, plus dt times the residual, on every cell,
and the check is the plain check_update (dflo_tpu/stab/mood.py:320-362).
On a masked domain solid cells count as missing neighbors of the plane ops
and never fail the check; the check is then this module's plain
check_update, as the reference's masked cascade runs its XLA check
(dflo_tpu/stab/mood.py:280-291, :348); unmasked on the fused route it is
the check kernel.  On P1 the check is the plain check_update with the u2
exemption off on every device: the basis has no D2 modes and the reference
has no check kernel below p = 2 (dflo_tpu/stab/mood.py:244-246, :284).  The
candidate, the modal positivity and the Pk post take every degree 1-6.

Options of the reference's make_mood: ``dmp_bounds="collapsed"`` (the
bounds its loop executes, every cell's interval collapsed to its own mean:
a superset of the neighborhood's failing cells, kept for validation,
dflo_tpu/stab/mood.py:308-310) and the warm start ``deg_in`` (the cascade
starts at a given degree map, its first pass the {truncation ->
positivity} candidate; the settled map is the fourth result,
dflo_tpu/stab/mood.py:314-318, :395-409).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dflo_tpu_torch.ops.contract import as_tensor, basis_reduce
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.stab.limiter import neighbor_valid
from dflo_tpu_torch.stab.positivity import make_positivity_limiter

DMP_EPS = 1.0e-6     # src/mood.cc:296
U2_EPS = 0.5         # src/mood.cc:271
U2_TINY = 1.0e-12    # curvatures at round-off level count as smooth (as
                     # dflo_tpu/stab/mood.py; not in the reference)


def neighborhood_min(a, valid):
    """min over {cell, existing face neighbors} of a [ny, nx] plane; valid
    = (W, E, S, N) neighbor-exists planes (non-wrapping at edges that are
    not periodic)."""
    vW, vE, vS, vN = valid
    big = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    m = a
    m = torch.minimum(m, torch.where(vW, torch.roll(a, 1, -1), big))
    m = torch.minimum(m, torch.where(vE, torch.roll(a, -1, -1), big))
    m = torch.minimum(m, torch.where(vS, torch.roll(a, 1, -2), big))
    m = torch.minimum(m, torch.where(vN, torch.roll(a, -1, -2), big))
    return m


def neighborhood_max(a, valid):
    vW, vE, vS, vN = valid
    big = torch.full((), float("-inf"), dtype=a.dtype, device=a.device)
    m = a
    m = torch.maximum(m, torch.where(vW, torch.roll(a, 1, -1), big))
    m = torch.maximum(m, torch.where(vE, torch.roll(a, -1, -1), big))
    m = torch.maximum(m, torch.where(vS, torch.roll(a, 1, -2), big))
    m = torch.maximum(m, torch.where(vN, torch.roll(a, -1, -2), big))
    return m


def dilate4(flag):
    """4-neighborhood dilation of a bool plane, wrapped at every edge (the
    residual kernel's stencil: a candidate reads its wrapped neighbors)."""
    out = flag | torch.roll(flag, 1, -1) | torch.roll(flag, -1, -1)
    return out | torch.roll(flag, 1, -2) | torch.roll(flag, -1, -2)


def dilate4_valid(flag, valid):
    """Validity-masked 4-neighborhood dilation of a bool plane: the spread
    reaches only existing face neighbors (src/mood.cc:341-394)."""
    vW, vE, vS, vN = valid
    out = flag
    out = out | (vW & torch.roll(flag, 1, -1)) | (vE & torch.roll(flag, -1, -1))
    out = out | (vS & torch.roll(flag, 1, -2)) | (vN & torch.roll(flag, -1, -2))
    return out


def u2_ok(d2xx, d2yy, valid):
    """Diot's u2 smoothness exemption on the density D2 Legendre planes
    (src/mood.cc:240-282): over the plus stencil, min and max of each D2
    share a sign and are comparable, or both are at round-off level."""
    ok = torch.ones(d2xx.shape, dtype=torch.bool, device=d2xx.device)
    for D2 in (d2xx, d2yy):
        mn = neighborhood_min(D2, valid)
        mx = neighborhood_max(D2, valid)
        amn = torch.abs(mn)
        amx = torch.abs(mx)
        flat = torch.maximum(amn, amx) < U2_TINY
        ok = ok & (flat | ((mn * mx >= 0) & (amn >= amx * (1.0 - U2_EPS))))
    return ok


def check_update(rho, d2xx, d2yy, dmp_min, dmp_max, deg, lim, valid,
                 mask=None):
    """DMP acceptance + degree-reduction / limiter-mark bookkeeping on a
    candidate (apply_mood, src/mood.cc:290-491).  rho is the candidate's
    density mean, d2xx/d2yy its density D2 modes, or None for a basis
    below p = 2, which has none: the u2 exemption is then off, every
    DMP-violating cell fails (dflo_tpu/stab/mood.py:244-246); deg int32,
    lim bool; mask: the bool fluid flags of a masked domain (a solid cell
    never fails, dflo_tpu/stab/mood.py:348), or None.  Returns (deg_new,
    lim_new, chg): chg marks the cells whose degree dropped."""
    dmp = (rho - dmp_min > -DMP_EPS) & (rho - dmp_max < DMP_EPS)
    if d2xx is None:
        fail = ~dmp
    else:
        fail = ~(dmp | u2_ok(d2xx, d2yy, valid))
    if mask is not None:
        fail = fail & mask
    red_self = fail & (deg > 1)
    mark_self = fail & (deg == 1) & ~lim
    spread = fail & (deg == 1) & lim
    nb = dilate4_valid(spread, valid)
    red_nb = nb & (deg > 1) & ~red_self
    mark_nb = nb & (deg == 1) & ~lim & ~mark_self
    chg = red_self | red_nb
    return deg - chg.to(deg.dtype), lim | mark_self | mark_nb, chg


class MoodStats(NamedTuple):
    """Per-stage cascade counters (src/claw.cc:851 printout): total degree
    reductions, cells handed to the TVB limiter (0-dim int64 tensors on the
    state's device) and cascade passes (a host int)."""
    n_reduce: torch.Tensor
    n_marked: torch.Tensor
    iters: int


class MoodStage:
    """mood_stage(u_pre, t, dt, deg_in=None) -> (u_candidate, limiter_marked,
    MoodStats, degree) for one SSP stage (dflo_tpu/stab/mood.py make_mood).
    rhs is the modal residual of solver/spatial.make_rhs: the fused one
    (its ``.step``, ``.modal_ops`` and, where it has one,
    ``.sparse_candidate``) or a plain one; mask the bool [ny, nx] fluid
    flags of a masked domain, or None; positivity whether Zhang-Shu
    re-limits each truncated predictor.  Any degree 1-6 the residual takes.

    With the fused residual and positivity on (``fused``), each pass's
    candidate goes through the port's kernels (their plain versions on CPU
    tensors): pass 1 is the dense modal residual's forward-Euler form
    u + dt*R(u); later passes are the sparse candidate on the cells that
    can change (sparse_mode="auto" with a residual that has one; see the
    module docstring), else the dense fused_modal_pos(u_pre, deg) followed
    by the dense forward-Euler residual on every cell.  Each pass ends in
    the check: the check kernel, or on a masked domain or below p = 2 the
    plain check_update (with the mask; on P1 with the u2 test off).
    Otherwise every pass is the plain arm on every cell, with the plain
    check.  host_syncs counts the ``bool(chg.any())`` reads."""

    def __init__(self, basis, mesh, rhs, per_x: bool = False,
                 per_y: bool = False, *, mask=None, max_iters: int = 20,
                 dmp_bounds: str = "neighborhood", sparse_mode: str = "auto",
                 positivity: bool = True):
        from dflo_tpu_torch.ops import kernels
        if basis.family != "Pk":
            raise ValueError("MOOD is implemented only for Pk "
                             "(src/parameters.cc:541-544)")
        if dmp_bounds not in ("neighborhood", "collapsed"):
            raise ValueError(f"unknown dmp_bounds {dmp_bounds!r}")
        if sparse_mode not in ("auto", "off"):
            raise ValueError(f"unknown sparse_mode {sparse_mode!r}")
        self.kernels = kernels
        self.p = basis.degree
        self.rhs = rhs
        self.max_iters = max_iters
        self.collapsed = dmp_bounds == "collapsed"
        # the reference's use_fused: its {truncation -> positivity} kernel
        # exists on the fused modal residual with positivity on
        self.fused = positivity and hasattr(rhs, "modal_ops")
        self.sparse = (self.fused and sparse_mode == "auto"
                       and hasattr(rhs, "sparse_candidate"))
        self.mops = rhs.modal_ops if self.fused else None
        self.avg0 = kernels.mode0_mean(basis)
        # an operator of the residual gives the dtype and device
        ref = (rhs.modal_ops.P if hasattr(rhs, "modal_ops")
               else rhs.lift_stack)
        device = ref.device
        self.mask = (None if mask is None
                     else torch.as_tensor(np.asarray(mask, bool),
                                          device=device))
        self.valid = tuple(torch.as_tensor(v, device=device) for v in
                           neighbor_valid((mesh.ny, mesh.nx), per_x, per_y,
                                          mask))
        # the check kernel's operators on the fused route; None below
        # p = 2, where the check is the plain one (the reference builds no
        # check kernel there), and on the plain arm
        self.cops = (kernels.mood_check_operators(basis, mesh, per_x=per_x,
                                                  per_y=per_y, device=device)
                     if self.fused and self.p >= 2 else None)
        # the plain arm's truncation masks [p + 1, K] (mode total degree
        # <= d, src/mood.cc:174-191), mean weights and positivity limiter
        kw = dict(dtype=ref.dtype, device=device)
        self.trunc = as_tensor(np.stack(
            [basis.mode_degree <= d for d in range(self.p + 1)]), **kw)
        self.avg_op = as_tensor(basis.wq2 @ basis.V, **kw)
        self.pos = (make_positivity_limiter(basis, **kw)
                    if positivity and not self.fused else None)
        self.host_syncs = 0

    def _forward(self, u, t, dt):
        """u + dt*R(u): the fused residual's forward-Euler form, or the
        plain residual's R and an axpy."""
        if hasattr(self.rhs, "step"):
            return self.rhs.step(u, t, dt)
        return u + dt * self.rhs(u, t)

    def _candidate(self, u_pre, deg, t, dt, ubar0):
        """The dense candidate of a degree map: {truncation -> positivity}
        of the predictor (the kernel on the fused route), then u + dt*R
        (dflo_tpu/stab/mood.py:320-332)."""
        if self.fused:
            u_t = self.kernels.fused_modal_pos(u_pre, self.mops, deg)
        else:
            u_t = u_pre * self.trunc[deg.long()].permute(2, 0, 1)[None]
            if self.pos is not None:
                u_t = self.pos(u_t, ubar0)
        return self._forward(u_t, t, dt)

    def _check(self, u_c, dmp_min, dmp_max, deg, lim):
        """One acceptance pass: the check kernel, or on a masked domain,
        below p = 2 or on the plain arm the plain check (the reference's
        XLA check: with the mask; on P1 with the u2 test off)."""
        if self.mask is None and self.cops is not None:
            return self.kernels.fused_mood_check(u_c, dmp_min, dmp_max, deg,
                                                 lim, self.cops)
        rho = u_c[euler.RHO]
        d2 = ((rho[2], rho[2 * self.p + 1]) if self.p >= 2
              else (None, None))
        return check_update(self.avg0 * rho[0], *d2, dmp_min, dmp_max,
                            deg, lim, self.valid, self.mask)

    def __call__(self, u_pre, t, dt, deg_in=None, live=None):
        """deg_in: optional int [ny, nx] degree map the cascade starts at
        (clipped to 1..p), the warm start; live: optional 0-dim bool
        tensor, when false the cascade stops after pass 1 (a step whose
        result the chunked loop discards).  The fourth result is the
        settled degree map (int32), which the JAX stage returns only with
        deg_in."""
        k = self.kernels
        ubar0 = None
        if self.pos is None:
            rho0 = self.avg0 * u_pre[euler.RHO, 0]
        else:
            # the plain positivity limits about the predictor's averages
            ubar0 = basis_reduce(self.avg_op, u_pre)
            rho0 = ubar0[euler.RHO]
        if self.collapsed:
            dmp_min = dmp_max = rho0
        else:
            dmp_min = neighborhood_min(rho0, self.valid)
            dmp_max = neighborhood_max(rho0, self.valid)
        shape = u_pre.shape[-2:]
        if deg_in is None:
            deg = torch.full(shape, self.p, dtype=torch.int32,
                             device=u_pre.device)
        else:
            deg = torch.clamp(deg_in.to(device=u_pre.device,
                                        dtype=torch.int32), 1, self.p)
        lim = torch.zeros(shape, dtype=torch.bool, device=u_pre.device)

        # ---- pass 1, peeled: the unmodified predictor's forward Euler, or
        # with a warm start the candidate of deg_in ------------------------
        if deg_in is None:
            u_c = self._forward(u_pre, t, dt)
        else:
            u_c = self._candidate(u_pre, deg, t, dt, ubar0)
        deg, lim, chg = self._check(u_c, dmp_min, dmp_max, deg, lim)
        it = 1
        # the cells (and their neighbors) whose pass-1 candidate skipped a
        # chain that moves them: none after a warm start's pass 1
        moved = None if deg_in is None else torch.zeros_like(chg)
        while it < self.max_iters:
            if live is not None:
                chg = chg & live
            self.host_syncs += 1
            if not bool(chg.any()):
                break
            if self.sparse:
                if moved is None:
                    # cells (and their neighbors) that the full-degree
                    # chain changes: the dense cascade's candidate differs
                    # from pass 1 there even where no degree changed
                    u_pos = k.fused_modal_pos(u_pre, self.mops)
                    moved = dilate4((u_pos != u_pre).flatten(0, 1).any(0))
                # candidates change only where a degree changed or a face
                # neighbor's did, or where the chain moved the predictor
                aff = chg | dilate4(chg) | moved
                u_c = self.rhs.sparse_candidate(u_pre, u_c, deg, t, dt, aff)
            else:
                u_c = self._candidate(u_pre, deg, t, dt, ubar0)
            deg, lim, chg = self._check(u_c, dmp_min, dmp_max, deg, lim)
            it += 1
        stats = MoodStats(torch.sum(self.p - deg), torch.sum(lim), it)
        return u_c, lim, stats, deg


#: dflo_tpu/stab/mood.py's builder name: make_mood(basis, mesh, rhs, per_x,
#: per_y, ...) -> mood_stage
make_mood = MoodStage
