"""Explicit solver driver for the RK/TVB method on one device.

The torch counterpart of dflo_tpu/driver.py's ``Solver`` for ``method="rk"``:
each SSP stage is one fused residual pass (residual + blend) followed by one
fused post pass (averages -> KXRCF -> characteristic TVB -> positivity), and
the final stage's post also yields the next step's CFL wave speed and the
fatal-negativity minimum.  The kernels are chosen by the device of the
state: on a CUDA tensor every wrapper launches its kernel, on a CPU tensor
it runs its plain version; the control flow is the same on both.

Configurations outside this slice raise NotImplementedError naming the
slice that brings them: MOOD and the modal Pk basis (slice B), masked
domains, other fluxes and indicators (physics envelope), device meshes
(multi-GPU slice).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import kernels
from dflo_tpu_torch.ops.contract import basis_reduce
from dflo_tpu_torch.solver import rk as rk_mod
from dflo_tpu_torch.solver.spatial import BoundarySide, _check_bcs, make_rhs
from dflo_tpu_torch.stab.positivity import EPS


@dataclasses.dataclass(frozen=True)
class LimiterConfig:
    """Mirrors Parameters::Limiter (src/parameters.h:241-256)."""
    type: str = "none"               # none | TVB
    shock_indicator: str = "limiter"  # limiter | density | energy
    M: float = 0.0
    beta: float = 1.0
    char_lim: bool = False
    pos_lim: bool = False
    conserve_angular_momentum: bool = False


class Solver:
    """Explicit RK/TVB DG solver on a Cartesian mesh, on one device."""

    def __init__(self, basis: basis_mod.Basis, mesh,
                 bcs: dict[str, BoundarySide], flux: str = "hllc",
                 limiter: LimiterConfig | None = None, cfl: float = 0.9, *,
                 dtype: torch.dtype, device, scheme: str | None = None,
                 method: str = "rk", mask=None, device_mesh=None):
        if method == "mood":
            raise NotImplementedError("method='mood' (MOOD on the modal Pk "
                                      "basis) comes with slice B of the port")
        if method != "rk":
            raise NotImplementedError(f"method {method!r} is not ported yet")
        if mask is not None:
            raise NotImplementedError("masked domains come with the physics "
                                      "envelope slice")
        if device_mesh is not None:
            raise NotImplementedError("device meshes come with the multi-GPU "
                                      "slice")
        cfg = limiter or LimiterConfig()
        if (cfg.type != "TVB" or cfg.conserve_angular_momentum
                or cfg.shock_indicator not in ("density", "energy")):
            raise NotImplementedError(
                "this slice carries the TVB limiter with the KXRCF density or "
                "energy indicator (no angular-momentum option)")
        self.basis = basis
        self.mesh = mesh
        self.bcs = bcs
        self.cfl = cfl
        self.dtype = dtype
        self.device = torch.device(device)
        self.method = method
        self.limiter_cfg = cfg
        per_x, per_y = _check_bcs(bcs)

        self.rhs = make_rhs(basis, mesh, bcs, flux=flux, dtype=dtype,
                            device=self.device, fused=True)
        self._post_ops = kernels.post_operators(
            basis, mesh, indicator=cfg.shock_indicator, M=cfg.M,
            beta=cfg.beta, char_lim=cfg.char_lim, pos_lim=cfg.pos_lim,
            per_x=per_x, per_y=per_y, dtype=dtype, device=self.device)
        self._diag_ops = kernels.diag_operators(basis, mesh, dtype=dtype,
                                                device=self.device)
        self.ark, self.stage_times = rk_mod.rk_coeffs(
            scheme or rk_mod.default_scheme(basis.degree))
        self._step = self._make_step()
        self._multi_cache: dict[int, Callable] = {}

    # ------------------------------------------------------------------
    def _scalar(self, x) -> torch.Tensor:
        """A 0-dim tensor of the solver dtype on its device.  Python floats
        go through a fill, never a host-to-device copy."""
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.full((), float(x), dtype=self.dtype, device=self.device)

    def cell_averages(self, u):
        return basis_reduce(self._diag_ops.avg, u)

    def post_stage(self, u, t=0.0):
        """Stabilization chain after each RK stage (src/claw.cc:762-766)."""
        return kernels.fused_post(u, self._post_ops)

    def _post_diag(self, u, t=0.0):
        """post_stage plus (lam_max, minq) of the stage's cell averages."""
        return kernels.fused_post(u, self._post_ops, with_diag=True)

    def _carry_lam_ok(self) -> bool:
        """Carry-λ eligibility (dflo_tpu/driver.py:469): the CFL wave speed
        can ride the chunk carry when the step's tail is the fused post with
        its diag and dt is the plain global-CFL form — always so for the RK
        method of this slice."""
        return self.method == "rk"

    def _make_step(self, carry_lam: bool = False):
        """step(u, t, t_end) -> (u, dt, bad, stats); carry_lam=True builds
        step(u, t, t_end, lam_prev) -> (..., lam_next) for the chunked loop:
        the wave speed comes from the previous step's final-stage post
        instead of a whole-state diag pass.  Nothing in it waits for the
        device."""
        if carry_lam:
            assert self._carry_lam_ok()
        denom = 2.0 * self.basis.degree + 1.0

        def step(u, t, t_end, lam_prev=None):
            t = self._scalar(t)
            t_end = self._scalar(t_end)
            if carry_lam:
                lam = lam_prev
            else:
                lam, _ = kernels.fused_diag(u, self._diag_ops)
            dt = torch.minimum(self.cfl / lam / denom, t_end - t)
            u, lam_new, minq = rk_mod.ssp_rk_step(
                self.rhs, u, t, dt, self.ark, self.stage_times,
                post_stage=self._post_diag, post_diag=True)
            bad = ~(minq >= EPS)            # NaN-safe
            if carry_lam:
                return u, dt, bad, (), lam_new
            return u, dt, bad, ()
        return step

    def _multi_step(self, chunk: int):
        """A loop of `chunk` steps with no host sync inside
        (dflo_tpu/driver.py:573): t, the Kahan compensator, the step count
        and `bad` stay 0-dim device tensors, and a step takes effect only
        while t < t_end - 1e-12 and `bad` is unset.  Returns
        multi(u, t, t_end) -> (u, t, n_done, bad, stats)."""
        if chunk not in self._multi_cache:
            step = self._make_step(carry_lam=True)

            def multi(u, t, t_end):
                t = self._scalar(t)
                t_end = self._scalar(t_end)
                comp = torch.zeros_like(t)
                it = torch.zeros((), dtype=torch.int64, device=self.device)
                bad = torch.zeros((), dtype=torch.bool, device=self.device)
                # seed once per chunk; thereafter the wave speed comes free
                # from the final stage's fused post diagnostics
                lam, _ = kernels.fused_diag(u, self._diag_ops)
                for _ in range(chunk):
                    live = (t < t_end - 1e-12) & ~bad
                    un, dt, bad_n, _st, lam_n = step(u, t, t_end, lam)
                    u = torch.where(live, un, u)
                    y = dt - comp
                    t2 = t + y
                    comp = torch.where(live, (t2 - t) - y, comp)
                    t = torch.where(live, t2, t)
                    it = it + live.to(it.dtype)
                    bad = bad | (live & bad_n)
                    lam = torch.where(live, lam_n, lam)
                return u, t, it, bad, ()

            self._multi_cache[chunk] = multi
        return self._multi_cache[chunk]

    # ------------------------------------------------------------------
    def run(self, u, t_end: float, t0: float = 0.0,
            callback: Callable | None = None, max_steps: int = 10**7,
            chunk: int = 1):
        """Advance u from t0 to t_end; callback(u, t, it) after every chunk.
        chunk > 1 runs that many steps per host round trip (one sync per
        chunk); failure flags and callbacks are then checked per chunk."""
        t, it = t0, 0
        # the reference limits the freshly-set IC before the first step
        # (src/claw.cc:997-1001)
        u = self.post_stage(u, t0)
        if chunk > 1:
            multi = self._multi_step(chunk)
            tdev = self._scalar(t)
            while t < t_end - 1e-12 and it < max_steps:
                u, tdev, n, bad, _stats = multi(u, tdev, t_end)
                if bool(bad):
                    raise FloatingPointError(
                        f"negative density/pressure cell average near "
                        f"t={float(tdev)!r} (src/positivity.cc:26-39 fatal "
                        f"condition)")
                t = float(tdev)
                it += int(n)
                if callback is not None:
                    callback(u, t, it)
                if int(n) == 0:
                    # the device loop (solver-dtype comparison) considers the
                    # run finished while host-double t is still below
                    # t_end - 1e-12: stop instead of re-dispatching
                    # zero-step chunks forever
                    break
            return u, t, it
        while t < t_end - 1e-12 and it < max_steps:
            u, dt, bad, _stats = self._step(u, t, t_end)
            if bool(bad):
                raise FloatingPointError(
                    f"negative density/pressure cell average at t={t!r} "
                    f"(src/positivity.cc:26-39 fatal condition)")
            t += float(dt)
            it += 1
            if callback is not None:
                callback(u, t, it)
            if float(dt) <= 0.0:
                # the solver-dtype clamp dt = min(dt, t_end - t) returned 0
                # (f32 half-ulp window below t_end): final time reached at
                # solver precision, and t += 0 would spin forever
                break
        return u, t, it

