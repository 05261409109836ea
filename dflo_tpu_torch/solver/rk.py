"""SSP Runge-Kutta time integration + CFL time-step control.

The torch counterpart of dflo_tpu/solver/rk.py: the Shu-Osher convex-blend
stages (src/claw.cc:141-159) and the Cartesian CFL formula
(compute_time_step_cartesian, src/claw.cc:483-512).  The reference's
``lax.scan`` over stages is a Python loop here; a ``post_stage`` hook applies
the stabilization chain after every stage (src/claw.cc:762-766).
"""

from __future__ import annotations

from typing import Callable

import torch

from dflo_tpu_torch.physics import euler


def rk_coeffs(scheme: str) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(ark, stage_times): Shu-Osher blend weights (src/claw.cc:141-159) and
    the stage time fractions used for time-dependent BC data."""
    if scheme == "rk1":
        return (0.0,), (0.0,)
    if scheme == "rk2":
        return (0.0, 0.5), (0.0, 1.0)
    if scheme == "rk3":
        return (0.0, 0.75, 1.0 / 3.0), (0.0, 1.0, 0.5)
    raise ValueError(f"unknown RK scheme {scheme!r}")


def default_scheme(degree: int) -> str:
    """The reference picks the RK order from the FE degree
    (src/claw.cc:141-159)."""
    return ("rk1", "rk2", "rk3")[min(degree, 2)]


def ssp_rk_step(rhs: Callable, u, t, dt, ark, stage_times,
                post_stage: Callable | None = None, post_diag: bool = False,
                dt_field=None):
    """One SSP-RK step u(t) -> u(t + dt); t and dt are 0-dim tensors on u's
    device (or Python floats on the CPU).

    If `rhs` has a ``.stage(u, u_old, t, a, dt)`` attribute (the fused
    residual kernel) and dt is a scalar, the residual and the SSP blend run
    as one pass per stage.  dt_field: a per-cell [ny, nx] dt for `time step
    type = local` pseudo-transient marching (src/claw.cc:444-481): each
    stage is then R (the kernel's R form on the fused path) and a torch
    blend, as the reference's, while the stage times still advance by the
    scalar dt.  post_diag=True: ``post_stage`` returns (u, lam_max, minq) and the step
    returns the FINAL stage's triple; the chain preserves cell means, so that
    lam/minq are the diagnostics of the step's result."""
    if post_diag and post_stage is None:
        raise ValueError("post_diag requires a post_stage")
    stage_fn = getattr(rhs, "stage", None) if dt_field is None else None
    dtu = dt if dt_field is None else dt_field
    u_old = u
    diag = None
    for a, c in zip(ark, stage_times):
        tc = t + c * dt
        if stage_fn is not None:
            u = stage_fn(u, u_old, tc, a, dt)
        else:
            u = u + dtu * rhs(u, tc)
            u = a * u_old + (1.0 - a) * u
        if post_stage is not None:
            if post_diag:
                u, lam, minq = post_stage(u, tc)
                diag = (lam, minq)
            else:
                u = post_stage(u, tc)
    return (u, *diag) if post_diag else u


def compute_dt(ubar, mesh, degree: int, cfl: float, mask=None):
    """Global CFL time step (0-dim tensor) from cell averages ubar[4, ny, nx]:
    dt_c = cfl / sum_d (c + |v_d|)/h / (2p+1), h = diameter/sqrt(dim).
    Solid cells (mask: bool [ny, nx] fluid flags on ubar's device) are
    left out of the min."""
    h = mesh.diameter_h
    c = euler.sound_speed(ubar)
    vx = torch.abs(ubar[euler.MX] / ubar[euler.RHO])
    vy = torch.abs(ubar[euler.MY] / ubar[euler.RHO])
    max_eig = (c + vx) / h + (c + vy) / h
    dt_cells = cfl / max_eig / (2.0 * degree + 1.0)
    if mask is not None:
        dt_cells = torch.where(mask, dt_cells,
                               torch.full_like(dt_cells, float("inf")))
    return torch.amin(dt_cells)


def local_dt(ubar, mesh, degree: int, cfl: float):
    """The per-cell dt field [ny, nx] of local (steady pseudo-transient)
    stepping, `time step type = local` (src/claw.cc:444-481): compute_dt's
    cell values without the min."""
    h = mesh.diameter_h
    c = euler.sound_speed(ubar)
    vx = torch.abs(ubar[euler.MX] / ubar[euler.RHO])
    vy = torch.abs(ubar[euler.MY] / ubar[euler.RHO])
    max_eig = (c + vx) / h + (c + vy) / h
    return cfl / max_eig / (2.0 * degree + 1.0)
