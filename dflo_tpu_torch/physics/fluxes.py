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

import math

import torch

from dflo_tpu_torch.physics.euler import (ENE, GAMMA, MX, MY, RHO, _pos,
                                          max_eigenvalue_normal, pressure)


#: reciprocals of the constant divisors, rounded once in double: the plain
#: fluxes multiply by them where the reference divides by the constant, and
#: the kernels (csrc/euler.cuh) multiply by the same values in the working
#: dtype, so both round alike on every device
_INV_G1 = 1.0 / (GAMMA - 1.0)
_INV_GAMMA = 1.0 / GAMMA


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


def steger_warming(UL, UR, nx, ny, AL=None, AR=None):
    """Steger-Warming flux-vector splitting (src/equation.h:382-464).  It
    reads no cell averages."""
    def split(U, sign):
        rho = U[RHO]
        vn = _vn(U, nx, ny)
        q2 = (U[MX] * U[MX] + U[MY] * U[MY]) / (rho * rho)
        p = pressure(U)
        c = torch.sqrt(GAMMA * _pos(p) / _pos(rho))
        if sign > 0:
            l1 = torch.clamp(vn, min=0.0)
            l2 = torch.clamp(vn + c, min=0.0)
            l3 = torch.clamp(vn - c, min=0.0)
        else:
            l1 = torch.clamp(vn, max=0.0)
            l2 = torch.clamp(vn + c, max=0.0)
            l3 = torch.clamp(vn - c, max=0.0)
        a = 2.0 * (GAMMA - 1.0) * l1 + l2 + l3
        fscale = 0.5 * rho * _INV_GAMMA
        fm = torch.stack([
            a * U[MX] / rho + c * (l2 - l3) * nx,
            a * U[MY] / rho + c * (l2 - l3) * ny,
            a,
            0.5 * a * q2 + c * vn * (l2 - l3)
            + c * c * (l2 + l3) * _INV_G1,
        ])
        return fscale * fm

    return split(UL, +1) + split(UR, -1)


def roe(UL, UR, nx, ny, AL=None, AR=None):
    """Roe flux with Harten entropy fix delta = 0.1c (src/equation.h:469-556).
    It reads no cell averages."""
    rl, rr = UL[RHO], UR[RHO]
    sl, sr = torch.sqrt(_pos(rl)), torch.sqrt(_pos(rr))
    fl = sl / (sl + sr)
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
    du_, dv_ = ur - ul, vr - vl
    v_dot_dv = u * du_ + v * dv_

    pl = (GAMMA - 1.0) * (UL[ENE] - 0.5 * rl * v2l)
    pr = (GAMMA - 1.0) * (UR[ENE] - 0.5 * rr * v2r)
    hl = GAMMA * pl / rl * _INV_G1 + 0.5 * v2l
    hr = GAMMA * pr / rr * _INV_G1 + 0.5 * v2r

    rho = sl * sr
    h = hl * fl + hr * fr
    c = torch.sqrt(_pos((GAMMA - 1.0) * (h - 0.5 * v2)))
    drho = rr - rl
    dp = pr - pl
    dvn = vnr - vnl

    a1 = (dp - rho * c * dvn) / (2.0 * c * c)
    a2 = drho - dp / (c * c)
    a3 = (dp + rho * c * dvn) / (2.0 * c * c)

    l1 = torch.abs(vn - c)
    l2 = torch.abs(vn)
    l3 = torch.abs(vn + c)
    delta = 0.1 * c
    l1 = torch.where(l1 < delta, 0.5 * (l1 * l1 / delta + delta), l1)
    l3 = torch.where(l3 < delta, 0.5 * (l3 * l3 / delta + delta), l3)

    d_rho = l1 * a1 + l2 * a2 + l3 * a3
    d_ene = (l1 * a1 * (h - c * vn) + l2 * a2 * 0.5 * v2
             + l2 * rho * (v_dot_dv - vn * dvn) + l3 * a3 * (h + c * vn))
    p_avg = 0.5 * (pl + pr)
    d_mx = ((u - nx * c) * l1 * a1 + u * l2 * a2
            + (du_ - nx * dvn) * l2 * rho + (u + nx * c) * l3 * a3)
    d_my = ((v - ny * c) * l1 * a1 + v * l2 * a2
            + (dv_ - ny * dvn) * l2 * rho + (v + ny * c) * l3 * a3)

    return torch.stack([
        nx * p_avg + 0.5 * (UL[MX] * vnl + UR[MX] * vnr) - 0.5 * d_mx,
        ny * p_avg + 0.5 * (UL[MY] * vnl + UR[MY] * vnr) - 0.5 * d_my,
        0.5 * (rl * vnl + rr * vnr - d_rho),
        0.5 * (rl * hl * vnl + rr * hr * vnr - d_ene),
    ])


def erf_approx(x):
    """Rational erf, Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7): the erf of
    the kernel form of kfvs, as in the reference's fused kernel, which has
    no erf (dflo_tpu/physics/fluxes.py:200-211)."""
    s = torch.sign(x)
    a = torch.abs(x)
    t = torch.reciprocal(1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


def _kinetic_split(U, sign, nx, ny, erf_fn=torch.special.erf):
    """Kinetic split flux of Deshpande/Mandal (src/equation.h:714-751)."""
    vn = _vn(U, nx, ny)
    p = pressure(U)
    beta = 0.5 * _pos(U[RHO]) / _pos(p)
    s = vn * torch.sqrt(beta)
    A = 0.5 * (1.0 + sign * erf_fn(s))
    B = 0.5 * sign * torch.exp(-s * s) / torch.sqrt(math.pi * beta)
    ufact = vn * A + B
    return torch.stack([
        p * nx * A + U[MX] * ufact,
        p * ny * A + U[MY] * ufact,
        U[RHO] * ufact,
        (U[ENE] + p) * vn * A + (U[ENE] + 0.5 * p) * B,
    ])


def kfvs(UL, UR, nx, ny, AL=None, AR=None):
    """KFVS flux (src/equation.h:756-782), with torch's erf.  It reads no
    cell averages."""
    return _kinetic_split(UL, +1, nx, ny) + _kinetic_split(UR, -1, nx, ny)


def kfvs_kernel(UL, UR, nx, ny, AL=None, AR=None):
    """kfvs with the A&S erf (erf_approx): the form of the residual kernel
    and its plain version (agrees with kfvs to 1.5e-7 relative)."""
    return (_kinetic_split(UL, +1, nx, ny, erf_fn=erf_approx)
            + _kinetic_split(UR, -1, nx, ny, erf_fn=erf_approx))


def logavg(a, b):
    """Logarithmic mean with the series guard (src_mpi/equation.h:26-45).
    f_safe keeps the untaken branch finite, and so its tangent."""
    xi = b / a
    f = (xi - 1.0) / (xi + 1.0)
    u = f * f
    u2 = u * u
    series = (1.0 + u * (1.0 / 3.0) + u2 * (1.0 / 5.0)
              + u2 * u * (1.0 / 7.0))
    small = u < 1.0e-2
    f_safe = torch.where(small, torch.ones_like(f), f)
    exact = torch.log(xi) / (2.0 * f_safe)
    F = torch.where(small, series, exact)
    return 0.5 * (a + b) / F


def _dot4(a, b):
    """a . b over the four components, as an ordered sum."""
    return ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3]


def kep(UL, UR, nx, ny, AL=None, AR=None):
    """Chandrashekar-style kinetic-energy-preserving, entropy-stable flux
    with eigen-decomposed entropy-variable dissipation (kep_flux +
    kep_diff_matrix, src_mpi/equation.h:748-920).  The dissipation matrix
    is evaluated on the cell averages AL/AR (the traces stand in without
    them), with a Rusanov-type eigenvalue bump BETA*|lambda_L - lambda_R|."""
    AL = UL if AL is None else AL
    AR = UR if AR is None else AR
    BETA = 1.0 / 6.0

    rl, rr = UL[RHO], UR[RHO]
    rho = logavg(rl, rr)
    ul, vl = UL[MX] / rl, UL[MY] / rl
    ur, vr = UR[MX] / rr, UR[MY] / rr
    v2l = ul * ul + vl * vl
    v2r = ur * ur + vr * vr
    u = 0.5 * (ul + ur)
    v = 0.5 * (vl + vr)
    vn = u * nx + v * ny
    vel2 = 0.5 * (v2l + v2r)

    pl = (GAMMA - 1.0) * (UL[ENE] - 0.5 * rl * v2l)
    pr = (GAMMA - 1.0) * (UR[ENE] - 0.5 * rr * v2r)
    betal = 0.5 * _pos(rl) / _pos(pl)
    betar = 0.5 * _pos(rr) / _pos(pr)
    beta = logavg(betal, betar)
    p = 0.5 * (rl + rr) / (betal + betar)

    # central entropy-conservative part (src_mpi/equation.h:891-897)
    f_rho = rho * vn
    f_mx = nx * p + u * f_rho
    f_my = ny * p + v * f_rho
    f_ene = (0.5 * (torch.reciprocal((GAMMA - 1.0) * beta) - vel2) * f_rho
             + f_mx * u + f_my * v)

    # --- dissipation matrix on the average states (kep_diff_matrix) -------
    arl, arr = AL[RHO], AR[RHO]
    arho = logavg(arl, arr)
    aul, avl = AL[MX] / arl, AL[MY] / arl
    aur, avr = AR[MX] / arr, AR[MY] / arr
    av2l = aul * aul + avl * avl
    av2r = aur * aur + avr * avr
    avnl = aul * nx + avl * ny
    avnr = aur * nx + avr * ny
    au = 0.5 * (aul + aur)
    av = 0.5 * (avl + avr)
    avn = au * nx + av * ny
    av2 = au * au + av * av

    apl = (GAMMA - 1.0) * (AL[ENE] - 0.5 * arl * av2l)
    apr = (GAMMA - 1.0) * (AR[ENE] - 0.5 * arr * av2r)
    abetal = 0.5 * _pos(arl) / _pos(apl)
    abetar = 0.5 * _pos(arr) / _pos(apr)
    abeta = logavg(abetal, abetar)
    aa = torch.sqrt(0.5 * GAMMA * torch.reciprocal(abeta))
    ap = 0.5 * (arl + arr) / (abetal + abetar)

    H = aa * aa * _INV_G1 + 0.5 * av2
    v1 = au * ny - av * nx
    one = torch.ones_like(arho)
    zero = torch.zeros_like(arho)
    # R columns: eigenvectors in (rho, mx, my, E) internal ordering
    Rcols = [
        (one, au - aa * nx, av - aa * ny, H - aa * avn),
        (one, au, av, 0.5 * av2),
        (zero, ny * one, -nx * one, v1),
        (one, au + aa * nx, av + aa * ny, H + aa * avn),
    ]
    al_ = torch.sqrt(GAMMA * _pos(apl) / _pos(arl))
    ar_ = torch.sqrt(GAMMA * _pos(apr) / _pos(arr))
    lam = [
        torch.abs(avn - aa) + BETA * torch.abs((avnl - al_) - (avnr - ar_)),
        torch.abs(avn),
        torch.abs(avn),
        torch.abs(avn + aa) + BETA * torch.abs((avnl + al_) - (avnr + ar_)),
    ]
    S = [0.5 * arho * _INV_GAMMA, (GAMMA - 1.0) * arho * _INV_GAMMA, ap,
         0.5 * arho * _INV_GAMMA]

    # jump in entropy variables (src_mpi/equation.h:902-908)
    ds = torch.log(pr / pl) - GAMMA * torch.log(rr / rl)
    dV = (-ds * _INV_G1 - (betar * v2r - betal * v2l),
          2.0 * (betar * ur - betal * ul),
          2.0 * (betar * vr - betal * vl),
          -2.0 * (betar - betal))

    # Diff = sum_k R_k (lam_k S_k) (R_k . dV), the terms in k order
    diff = None
    for k in range(4):
        w = lam[k] * S[k] * _dot4(Rcols[k], dV)
        term = [r * w for r in Rcols[k]]
        diff = term if diff is None else [d + t for d, t in zip(diff, term)]

    return torch.stack([
        f_mx - 0.5 * diff[1],
        f_my - 0.5 * diff[2],
        f_rho - 0.5 * diff[0],
        f_ene - 0.5 * diff[3],
    ])


FLUX_FUNCTIONS = {
    "lxf": lxf,
    "sw": steger_warming,
    "roe": roe,
    "hllc": hllc,
    "kfvs": kfvs,
    "kep": kep,
}


def get_flux(name: str, kernel_safe: bool = False):
    """Flux by prm name; kernel_safe=True gives kfvs_kernel for kfvs, the
    form the residual kernel and its plain version evaluate (the reference's
    kernel does the same, dflo_tpu/ops/pallas_kernels.py:272-273)."""
    if kernel_safe and name == "kfvs":
        return kfvs_kernel
    try:
        return FLUX_FUNCTIONS[name]
    except KeyError:
        raise ValueError(f"unknown numerical flux {name!r}; "
                         f"choose from {sorted(FLUX_FUNCTIONS)}") from None
