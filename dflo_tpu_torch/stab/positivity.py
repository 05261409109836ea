"""Zhang-Shu positivity-preserving limiter, vectorized and branchless.

The torch counterpart of dflo_tpu/stab/positivity.py (apply_positivity_limiter,
src/positivity.cc:16-208): density and pressure are checked at the mixed
GLL x Gauss point sets (src/positivity.cc:42-46), and cells squeeze toward
their average with theta1 (density) and theta2 (pressure, from the per-point
quadratic root solve of src/positivity.cc:140-177).  The fatal
negative-average abort (src/positivity.cc:26-39) is surfaced by
`negative_average_flag` so the host loop can raise.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import quadrature
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply_ordered, recip
from dflo_tpu_torch.physics import euler

EPS = 1.0e-13  # src/positivity.cc:27

#: f32 relative floor (~32 ulps): the absolute 1e-13 floor sits far below f32
#: squeeze rounding, and with it Mach-10 shocks produced NaN in f32
REL_F32 = 4.0e-6


def pos_floors(ubar, dtype: torch.dtype):
    """Per-cell (eps_rho, eps_p) floors: the reference's absolute EPS in f64
    (src/positivity.cc:27), relative floors in every narrower dtype."""
    if dtype == torch.float64:
        e = torch.full((), EPS, dtype=dtype, device=ubar.device)
        return e, e
    eps_r = torch.clamp(REL_F32 * ubar[euler.RHO], min=EPS)
    eps_p = torch.clamp(REL_F32 * euler.pressure(ubar), min=EPS)
    return eps_r, eps_p


def _pos_points(degree: int) -> np.ndarray:
    """Mixed GLL x Gauss point sets (src/positivity.cc:42-46): 2N-3 >= degree.
    For degree 2 this gives 18 points."""
    N = (degree + 3) // 2 if (degree + 3) % 2 == 0 else (degree + 4) // 2
    xg, _ = quadrature.gauss_lobatto(N)
    xq, _ = quadrature.gauss(degree + 1)
    # set 1: GLL in x, Gauss in y; set 2: swapped
    px = np.array([(a, b) for b in xq for a in xg])
    py = np.array([(a, b) for b in xg for a in xq])
    return np.concatenate([px, py], axis=0)


def make_positivity_limiter(basis: basis_mod.Basis, *, dtype: torch.dtype,
                            device):
    """Build limit(u, ubar) -> u (Zhang-Shu scaling).  Nodal bases scale
    every DoF about the average; the modal Pk basis scales the non-mean
    coefficients and mixes mode 0 with the average (scale_about_avg,
    src/positivity.cc:90-110)."""
    P = as_tensor(basis.eval_at(_pos_points(basis.degree)), dtype, device)
    modal = basis.family == "Pk"
    # 1/(gamma-1) rounded in the working dtype, as the kernels multiply by it
    inv_g1 = recip(euler.GAMMA - 1.0, P)

    def scale(v, vbar, theta):
        """theta*v + (1-theta)*vbar per cell; v [c, K, ...], vbar [c, ...]."""
        if modal:
            return torch.cat([v[:, :1] * theta + vbar[:, None] * (1.0 - theta),
                              v[:, 1:] * theta], dim=1)
        return v * theta + vbar[:, None] * (1.0 - theta)

    def limit(u, ubar):
        eps_r, eps_p = pos_floors(ubar, u.dtype)
        # ---- density pass (src/positivity.cc:68-111) ----------------------
        # point values as ordered sums, as the kernels compute them: the
        # pressure-floor branches below are decided by their rounding
        W = basis_apply_ordered(P, u)                  # [4, Qp, ny, nx]
        rho_min = torch.amin(W[euler.RHO], dim=0)      # [ny, nx]
        rho_avg = ubar[euler.RHO]
        rat = torch.abs(rho_avg - eps_r) / (torch.abs(rho_avg - rho_min)
                                            + 1.0e-13)
        theta1 = torch.clamp(rat, max=1.0)
        u_rho = scale(u[euler.RHO:euler.RHO + 1], rho_avg[None], theta1)[0]
        u = torch.stack([u[euler.MX], u[euler.MY], u_rho, u[euler.ENE]])

        # ---- pressure pass (src/positivity.cc:113-182) --------------------
        # only density changed, and the squeeze acts identically on point
        # values: update W's density row analytically
        W_rho = W[euler.RHO] * theta1 + rho_avg[None] * (1.0 - theta1)
        W = torch.stack([W[euler.MX], W[euler.MY], W_rho, W[euler.ENE]])
        pre = euler.pressure(W)
        d = W - ubar[:, None]                          # deviations from avg
        drho, dE = d[euler.RHO], d[euler.ENE]
        dmx, dmy = d[euler.MX], d[euler.MY]
        mavg_x, mavg_y = ubar[euler.MX][None], ubar[euler.MY][None]
        ravg, Eavg = ubar[euler.RHO][None], ubar[euler.ENE][None]

        epn = eps_p if eps_p.dim() == 0 else eps_p[None]
        a1 = 2.0 * drho * dE - (dmx * dmx + dmy * dmy)
        b1 = (2.0 * drho * (Eavg - epn * inv_g1)
              + 2.0 * ravg * dE - 2.0 * (mavg_x * dmx + mavg_y * dmy))
        c1 = (2.0 * ravg * Eavg - (mavg_x**2 + mavg_y**2)
              - 2.0 * epn * ravg * inv_g1)
        a1s = torch.where(a1 == 0.0, torch.ones_like(a1), a1)
        b1n, c1n = b1 / a1s, c1 / a1s
        D = torch.sqrt(torch.abs(b1n * b1n - 4.0 * c1n))
        t1 = 0.5 * (-b1n - D)
        t2 = 0.5 * (-b1n + D)
        t1_ok = (t1 > -1.0e-12) & (t1 < 1.0 + 1.0e-12)
        t = torch.where(t1_ok, t1, t2)
        t = torch.clamp(t, 0.0, 1.0)
        t = torch.where(torch.abs(1.0 - t) < 1.0e-14, torch.zeros_like(t), t)
        t = torch.where(pre < epn, t, torch.ones_like(t))
        theta2 = torch.amin(t, dim=0)                  # [ny, nx]
        return scale(u, ubar, theta2)

    return limit


def negative_average_flag(ubar, mask=None):
    """0-dim bool tensor: any (fluid) cell-average density or pressure < EPS
    — the fatal condition of src/positivity.cc:26-39.  Written as
    ~(x >= EPS) so NaN states also trip it.  mask: bool [ny, nx] fluid
    flags on ubar's device, or None."""
    bad = ~(torch.minimum(ubar[euler.RHO], euler.pressure(ubar)) >= EPS)
    if mask is not None:
        bad = bad & mask
    return torch.any(bad)
