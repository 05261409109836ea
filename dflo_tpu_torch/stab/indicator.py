"""Shock indicators as whole-domain tensor sweeps.

The torch counterpart of dflo_tpu/stab/indicator.py: the `limiter` kind,
which marks every cell (src/indicator.cc:19-22); the KXRCF density and
energy indicators (compute_shock_indicator_kxrcf, src/indicator.cc:48-198):
per cell, the inflow-part boundary integral of the jump in the indicator
variable, normalized by h^{(p+1)/2} * inflow measure * cell average, where
boundary faces, and faces to a solid cell of a masked domain, contribute no
jump (src/indicator.cc:174-179); Diot's `u2` smoothness test on the density
D2 modes of the Pk basis (src/indicator.cc:34-46, src/mood.cc:233-282);
and the `residual` indicator, the RMS of du/dt per cell against 1e-12
(src_gll/indicator.cc:40-62), which marks nearly every cell of a float32
state, as the reference's does.  A cell is marked (limiter active) when the
indicator exceeds 1 (src/limiter.cc:263).
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.basis import EAST, NORTH, SOUTH, WEST
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply1, quad_reduce1
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.stab.limiter import neighbor_valid
from dflo_tpu_torch.stab.mood import u2_ok


def _full(like, value: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-dim tensor of value in dtype on like's device (a Python scalar
    in torch.where would round through float32)."""
    return torch.full((), value, dtype=dtype, device=like.device)


def make_shock_indicator(basis: basis_mod.Basis, mesh, kind: str = "density",
                         per_x: bool = False, per_y: bool = False,
                         mask: np.ndarray | None = None, *,
                         dtype: torch.dtype, device, rhs=None):
    """Build indicator(u, ubar, t=0.0, valid=None) -> (shock_ind[ny,nx],
    jump_ind[ny,nx]).

    kind : 'limiter' (mark all, src/indicator.cc:19-22) | 'density' |
           'energy' (KXRCF) | 'u2' (Pk, p >= 2: the density D2 modes 2 and
           2p + 1 over the plus stencil, dflo_tpu/stab/indicator.py:48-70) |
           'residual' (the RMS of rhs(u, t) over components and modes
           against 1e-12; needs `rhs`; its second result is the RMS).
    mask : optional bool [ny, nx] fluid flags; faces whose neighbor is solid
           count like boundary faces.
    valid: the call's own neighbor-exists flags (W, E, S, N), bool [ny, nx]
           each, in place of the ones built here for the mesh (the post's
           block form passes those of a block framed by its halo lines).
    """
    if kind == "limiter":
        def mark_all(u, ubar, t=0.0, valid=None):
            shape = u.shape[-2:]
            return (torch.full(shape, 1e20, dtype=dtype, device=u.device),
                    torch.zeros(shape, dtype=dtype, device=u.device))
        return mark_all
    if kind == "u2":
        if basis.family != "Pk" or basis.degree < 2:
            raise ValueError("u2 indicator needs the Pk basis with degree "
                             ">= 2 (src/mood.cc:215-231 modal coefficients)")
        p = basis.degree
        valid_u2 = tuple(torch.as_tensor(v, device=device) for v in
                         neighbor_valid((mesh.ny, mesh.nx), per_x, per_y,
                                        mask))

        def u2_indicator(u, ubar, t=0.0, valid=None):
            ok = u2_ok(u[euler.RHO, 2], u[euler.RHO, 2 * p + 1],
                       valid_u2 if valid is None else valid)
            shock = torch.where(ok, _full(ok, 0.0, dtype), _full(ok, 1e20,
                                                                  dtype))
            return shock, torch.zeros_like(shock)
        return u2_indicator
    if kind == "residual":
        if rhs is None:
            raise ValueError("residual indicator needs the rhs function")

        def residual_indicator(u, ubar, t=0.0, valid=None):
            r = rhs(u, t)                             # [4, K, ny, nx]
            rms = torch.sqrt(torch.mean(r * r, dim=(0, 1)))
            shock = torch.where(rms > 1.0e-12, _full(rms, 1e20, dtype),
                                _full(rms, 0.0, dtype))
            return shock, rms
        return residual_indicator
    if kind not in ("density", "energy"):
        raise ValueError(f"unknown shock indicator {kind!r}")
    comp = {"density": euler.RHO, "energy": euler.ENE}[kind]
    faceV = [as_tensor(basis.faceV[f], dtype, device) for f in range(4)]
    wq = as_tensor(basis.wq, dtype, device)
    dx, dy = mesh.dx, mesh.dy
    diam = float(np.sqrt(dx * dx + dy * dy))
    h = mesh.diameter_h
    p = basis.degree
    valid_mesh = tuple(as_tensor(v, dtype, device) for v in
                       neighbor_valid((mesh.ny, mesh.nx), per_x, per_y,
                                      mask))

    def indicator(u, ubar, t=0.0, valid=None):
        vW, vE, vS, vN = (valid_mesh if valid is None
                          else (f.to(u.dtype) for f in valid))
        v = u[comp]                                   # [K, ny, nx]
        tW = basis_apply1(faceV[WEST], v)             # [nq, ny, nx]
        tE = basis_apply1(faceV[EAST], v)
        tS = basis_apply1(faceV[SOUTH], v)
        tN = basis_apply1(faceV[NORTH], v)

        # neighbor traces across each face; skipped faces get zero jump
        jW = (tW - torch.roll(tE, 1, dims=2)) * vW
        jE = (tE - torch.roll(tW, -1, dims=2)) * vE
        jS = (tS - torch.roll(tN, 1, dims=1)) * vS
        jN = (tN - torch.roll(tS, -1, dims=1)) * vN

        # inflow flags per face from cell-average velocity (vel . n < 0)
        vx = ubar[euler.MX] / ubar[euler.RHO]
        vy = ubar[euler.MY] / ubar[euler.RHO]
        inW = (-vx < 0) * vW
        inE = (vx < 0) * vE
        inS = (-vy < 0) * vS
        inN = (vy < 0) * vN

        def fint(j):
            return quad_reduce1(wq, j)

        ind = (inW * fint(jW) + inE * fint(jE)) * dy \
            + (inS * fint(jS) + inN * fint(jN)) * dx
        measure = (inW + inE) * dy + (inS + inN) * dx

        denom = diam ** (0.5 * (p + 1)) * measure * ubar[comp]
        safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        shock = torch.where(torch.abs(denom) > 0.0, torch.abs(ind) / safe,
                            torch.zeros_like(denom))

        jump2 = ((fint(jW**2) * vW + fint(jE**2) * vE) * dy
                 + (fint(jS**2) * vS + fint(jN**2) * vN) * dx)
        jump = torch.sqrt(jump2 / (4.0 * h)) * diam
        return shock, jump

    return indicator
