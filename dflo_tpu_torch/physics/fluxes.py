"""Numerical (Riemann) fluxes, vectorized and branchless.

The torch counterparts of dflo_tpu/physics/fluxes.py.  A flux takes
left/right traces ``UL, UR [4, ...]`` and the unit-normal components
``nx, ny`` (and, for the fluxes that read them, the cell averages ``AL, AR``
of the two cells) and returns the numerical normal flux ``[4, ...]``.
Control flow is ``torch.where`` selects, written in the same order as the
reference so the CUDA twins in csrc/euler.cuh can follow them operation by
operation.
"""

from __future__ import annotations

import torch

from dflo_tpu_torch.physics.euler import (ENE, GAMMA, MX, MY, RHO, _pos,
                                          max_eigenvalue_normal, pressure)


def _vn(U, nx, ny):
    return (U[MX] * nx + U[MY] * ny) / U[RHO]


def lxf(UL, UR, nx, ny, AL=None, AR=None):
    """Local Lax-Friedrichs (src/equation.h:324-377).  The dissipation speed
    comes from the cell averages AL/AR, as the reference's lxf_flux does
    (src/assemble_explicit.cc:335-340); the traces stand in without them."""
    AL = UL if AL is None else AL
    AR = UR if AR is None else AR
    vnl, vnr = _vn(UL, nx, ny), _vn(UR, nx, ny)
    pl, pr = pressure(UL), pressure(UR)
    lam = torch.maximum(max_eigenvalue_normal(AL, nx, ny),
                        max_eigenvalue_normal(AR, nx, ny))
    f = torch.stack([
        0.5 * (pl * nx + UL[MX] * vnl + pr * nx + UR[MX] * vnr),
        0.5 * (pl * ny + UL[MY] * vnl + pr * ny + UR[MY] * vnr),
        0.5 * (UL[RHO] * vnl + UR[RHO] * vnr),
        0.5 * ((UL[ENE] + pl) * vnl + (UR[ENE] + pr) * vnr),
    ])
    return f + 0.5 * lam * (UL - UR)


def hllc(UL, UR, nx, ny, AL=None, AR=None):
    """HLLC flux, SU2-derived variant (src/equation.h:559-681), branchless.
    It reads no cell averages (AL, AR)."""
    rl, rr = UL[RHO], UR[RHO]
    sl_, sr_ = torch.sqrt(_pos(rl)), torch.sqrt(_pos(rr))
    fl = sl_ / (sl_ + sr_)
    fr = 1.0 - fl

    ul, vl = UL[MX] / rl, UL[MY] / rl
    ur, vr = UR[MX] / rr, UR[MY] / rr
    v2l = ul * ul + vl * vl
    v2r = ur * ur + vr * vr
    vnl = ul * nx + vl * ny
    vnr = ur * nx + vr * ny
    u = ul * fl + ur * fr
    v = vl * fl + vr * fr
    vn = u * nx + v * ny
    v2 = u * u + v * v

    pl = (GAMMA - 1.0) * (UL[ENE] - 0.5 * rl * v2l)
    pr = (GAMMA - 1.0) * (UR[ENE] - 0.5 * rr * v2r)
    hl = (UL[ENE] + pl) / rl
    hr = (UR[ENE] + pr) / rr
    cl = torch.sqrt(GAMMA * _pos(pl) / _pos(rl))
    cr = torch.sqrt(GAMMA * _pos(pr) / _pos(rr))
    el = UL[ENE] / rl
    er = UR[ENE] / rr

    h = hl * fl + hr * fr
    c = torch.sqrt(_pos((GAMMA - 1.0) * (h - 0.5 * v2)))

    s_l = torch.minimum(vn - c, vnl - cl)
    s_r = torch.maximum(vn + c, vnr + cr)
    s_m = (pl - pr - rl * vnl * (s_l - vnl) + rr * vnr * (s_r - vnr)) / (
        rr * (s_r - vnr) - rl * (s_l - vnl))
    p_star = rr * (vnr - s_r) * (vnr - s_m) + pr

    # pure upwind fluxes
    f_l = torch.stack([rl * ul * vnl + pl * nx, rl * vl * vnl + pl * ny,
                       rl * vnl, el * rl * vnl + pl * vnl])
    f_r = torch.stack([rr * ur * vnr + pr * nx, rr * vr * vnr + pr * ny,
                       rr * vnr, er * rr * vnr + pr * vnr])

    def star(rho, uu, vv, vnn, p, e, s):
        den = s - s_m
        den = torch.where(torch.abs(den) < 1e-300, torch.ones_like(den), den)
        inv = 1.0 / den
        smu = s - vnn
        rho_s = rho * smu * inv
        mx_s = (rho * uu * smu + (p_star - p) * nx) * inv
        my_s = (rho * vv * smu + (p_star - p) * ny) * inv
        e_s = (smu * e * rho - p * vnn + p_star * s_m) * inv
        return torch.stack([mx_s * s_m + p_star * nx,
                            my_s * s_m + p_star * ny,
                            rho_s * s_m,
                            (e_s + p_star) * s_m])

    f_star_l = star(rl, ul, vl, vnl, pl, el, s_l)
    f_star_r = star(rr, ur, vr, vnr, pr, er, s_r)

    left = torch.where(s_l > 0.0, f_l, f_star_l)       # s_m >= 0 branch
    right = torch.where(s_r >= 0.0, f_star_r, f_r)     # s_m <  0 branch
    return torch.where(s_m >= 0.0, left, right)


FLUX_FUNCTIONS = {"hllc": hllc, "lxf": lxf}

#: the reference's other fluxes, ported with the physics envelope slice
_LATER = ("sw", "roe", "kfvs", "kep")


def get_flux(name: str):
    """Flux by prm name."""
    if name in FLUX_FUNCTIONS:
        return FLUX_FUNCTIONS[name]
    if name in _LATER:
        raise NotImplementedError(
            f"numerical flux {name!r} is not ported yet; the port carries "
            f"hllc and lxf (the other fluxes come with the physics envelope "
            f"slice, ROADMAP queue 1, item 4)")
    raise ValueError(f"unknown numerical flux {name!r}; choose from "
                     f"{sorted(FLUX_FUNCTIONS) + list(_LATER)}")
