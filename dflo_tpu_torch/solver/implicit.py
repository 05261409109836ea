"""Implicit theta-scheme via matrix-free Newton-Krylov.

The torch counterpart of dflo_tpu/solver/implicit.py.  With the blended
state W_theta = theta*u + (1-theta)*u_old (src/assemble_implicit.cc:125-135)
each step solves

    F(u) = (u - u_old) / dt  -  R(W_theta, t) = 0

(R the mass-solved spatial operator du/dt; dt a scalar, or a per-cell field
for `time step type = local` pseudo-transient stepping, src/claw.cc:
444-481) by Newton's method: each iteration evaluates F, solves the
linearized system J du = -F with GMRES to the relative tolerance
`linear_residual` (src/claw.cc:669-670), applies the update and runs the
driver's stabilization chain (src/claw.cc:905-911); the loop ends below the
absolute tolerance 1e-10 or at the iteration cap (src/claw.cc:925-930), and
divergence (a non-finite or exploding residual) is flagged for the driver
(src/claw.cc:919-923).  No matrix is formed: the Krylov operator and the
block-Jacobi probes are Jacobian-vector products of the plain residual
(:func:`linearize_plain`).

Primal and tangent go different ways, as in the reference
(fused_primal_rhs, dflo_tpu/solver/implicit.py:64-98): every evaluation of
F itself (the Newton residuals, the final ||F||, run_steady's ||R(u)||)
runs the residual kernel's R form, and every tangent (the GMRES operator,
the probe columns, the achieved linear residual) a Jacobian-vector product
of the plain residual (make_rhs(..., volume_kernel="xla")), never the
kernel's plain twin.  The reference has no tangent kernel either.

GMRES (:func:`gmres`) is jax.scipy.sparse.linalg.gmres(solve_method=
"batched") written in torch, with one host read per restart (its outer
test ||M r|| > atol); the Newton loop reads ||F|| once per iteration when
it may take another.  Every step counts its Newton iterations, restarts,
tangent applications, primal evaluations and host reads (KrylovCounts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.solver import rk as rk_mod

#: absolute Newton stopping tolerance (src/claw.cc:925-927)
NEWTON_ATOL = 1.0e-10
#: residual growth beyond this factor of the first iterate flags divergence
DIVERGENCE_FACTOR = 1.0e6


class NewtonInfo(NamedTuple):
    """Per-step Newton diagnostics (src/claw.cc:913-914), 0-dim tensors on
    the state's device: res0, ||F|| entering the first iteration; res,
    ||F|| after the last; iters, the iterations performed; diverged
    (bool); lin_res, the achieved relative linear residual of the last
    GMRES solve in the left-preconditioned norm, ||M r|| / ||M F|| (the
    reference's printed convergence, warn-checked against lin_tol,
    src/claw.cc:677-687)."""
    res0: torch.Tensor
    res: torch.Tensor
    iters: torch.Tensor
    diverged: torch.Tensor
    lin_res: torch.Tensor


@dataclasses.dataclass
class KrylovCounts:
    """What the implicit path did since the last reset: Newton iterations,
    GMRES restarts, tangent applications (Jacobian-vector products of the
    plain residual), primal evaluations (the residual kernel's R form) and
    host reads of device values."""
    newton: int = 0
    restarts: int = 0
    tangents: int = 0
    primals: int = 0
    host_reads: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FusedPrimalRhs:
    """The residual kernel for the primal, the plain residual's
    Jacobian-vector products for the tangent (the reference's
    fused_primal_rhs, dflo_tpu/solver/implicit.py:64-98).

    ``rhs(u, t)`` is ``fused(u, t)``: the kernel's R form (its plain twin
    on CPU tensors).  ``rhs.linearize(u, t)`` is the closure v -> J v with
    J = dR/du of ``plain`` (make_rhs(..., volume_kernel="xla")) at u
    (linearize_plain).  A plain object rather than a
    torch.autograd.Function: autograd would hand the kernel wrapper tensors
    it records or wraps, which the ctypes launch cannot take, and the two
    halves never meet in one call anyway.  ``fused`` keeps the fused rhs's
    attributes (strips, stage, ops)."""

    def __init__(self, fused: Callable, plain: Callable):
        self.fused = fused
        self.plain = plain

    def __call__(self, u, t):
        return self.fused(u, t)

    def linearize(self, u, t) -> Callable:
        return linearize_plain(self.plain, u, t)


def linearize_plain(rhs: Callable, u, t) -> Callable:
    """v -> dR/du(u) v of a plain (differentiable) rhs, as jax.linearize
    gives it: R is evaluated once at u with autograd recording, and one
    reverse pass with create_graph gives g(w) = J^T w as a graph linear in
    w; each application is then one reverse pass through that graph,
    d(g(w) . v)/dw = J v.  The same products as forward mode in another
    summation order (round-off apart).  Forward mode itself
    (torch.func.jvp) gives the same values but, in the torch this was
    built on, routes every operation that mixes a tangent with a constant
    (a Python scalar, an operator matrix) through a zero tensor whose
    shape is worked out in Python: 190 ms per application of the 16 x 16
    Q1 residual on a CPU core, 20 ms this way (PERF.md, PR 8)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        w = torch.zeros_like(uu, requires_grad=True)
        g, = torch.autograd.grad(rhs(uu, t), uu, w, create_graph=True)

    def apply(v):
        with torch.enable_grad():
            return torch.autograd.grad(g, w, v, retain_graph=True)[0]

    return apply


def linearize(rhs: Callable, u, t) -> Callable:
    """The tangent of rhs at u: its own ``linearize`` (FusedPrimalRhs), or
    linearize_plain of rhs itself (a plain rhs)."""
    lin = getattr(rhs, "linearize", None)
    return lin(u, t) if lin is not None else linearize_plain(rhs, u, t)


# ---------------------------------------------------------------------------
# GMRES: jax.scipy.sparse.linalg.gmres(solve_method="batched")
# ---------------------------------------------------------------------------

def _norm(x):
    return torch.sqrt(torch.dot(x, x))


def _safe_normalize(x, thresh=None):
    """(x / ||x||, ||x||), or (0, 0) where ||x|| <= thresh (default the
    dtype's epsilon), as jax's _safe_normalize."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    unit = torch.where(use, x / norm, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return unit, torch.where(use, norm, torch.zeros_like(norm))


def _arnoldi_step(k, A, M, V):
    """The k-th Arnoldi step (jax's _kth_arnoldi_iteration): v = M(A(V[k]))
    orthogonalized against the rows of V by classical Gram-Schmidt
    (_iterative_classical_gram_schmidt with max_iterations=2, whose loop
    condition k < max_iterations - 1 no longer holds after its first
    projection, so one projection is all it does), normalized with the
    threshold eps*||v||.  Returns (unit v, the row h of H, breakdown)."""
    v = M(A(V[k]))
    _, v_norm_0 = _safe_normalize(v)
    h = V @ v                                  # overlaps with every row
    v = v - V.T @ h
    tol = torch.finfo(v.dtype).eps * v_norm_0
    unit, v_norm_1 = _safe_normalize(v, thresh=tol)
    h = h.clone()
    h[k + 1] = v_norm_1
    return unit, h, v_norm_1 == 0.0


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart (jax's _gmres_batched): `restart` Arnoldi steps (the
    rows after a breakdown keep their initial values, as jax's loop stops
    there; the steps still run, so the host never waits), the least squares
    problem through its normal equations and a Cholesky solve (jax's
    _lstsq, solve(assume_a="pos"); a failed factorization gives NaN, as
    there), the update x0 + V^T y and the new preconditioned residual."""
    n = b.numel()
    V = torch.zeros((restart + 1, n), dtype=b.dtype, device=b.device)
    V[0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        unit, h, breakdown = _arnoldi_step(k, A, M, V)
        V[k + 1] = torch.where(broken, V[k + 1], unit)
        H[k] = torch.where(broken, H[k], h)
        broken = broken | breakdown
    beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta[0] = residual_norm
    a2 = H @ H.T
    b2 = H @ beta
    L, info = torch.linalg.cholesky_ex(a2)
    y = torch.cholesky_solve(b2[:, None], L)[:, 0]
    y = torch.where(info == 0, y, torch.full_like(y, float("nan")))
    x = x0 + V[:-1].T @ y
    residual = M(b - A(x))
    unit_residual, residual_norm = _safe_normalize(residual)
    return x, unit_residual, residual_norm


def gmres(A: Callable, b, M: Callable | None = None, *, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter: int | None = None,
          counts: KrylovCounts | None = None):
    """Solve A x = b from x0 = 0, as jax.scipy.sparse.linalg.gmres(A, b,
    tol=tol, atol=atol, restart=restart, maxiter=maxiter, M=M,
    solve_method="batched"): restarts while k < maxiter and the
    preconditioned residual ||M(b - A x)|| exceeds max(tol*||b||, atol),
    one host read per test.  A and M map b-shaped tensors to b-shaped
    tensors (M None: the identity); b's dtype and device carry through.
    A(0) is not applied for the first residual: it is 0 for a linear A."""
    counts = counts if counts is not None else KrylovCounts()
    shape = b.shape
    bf = b.reshape(-1)
    n = bf.numel()

    def Af(v):
        return A(v.reshape(shape)).reshape(-1)

    if M is None:
        def Mf(v):
            return v
    else:
        def Mf(v):
            return M(v.reshape(shape)).reshape(-1)

    maxiter = 10 * n if maxiter is None else maxiter
    restart = min(restart, n)
    atol_t = torch.clamp(tol * _norm(bf), min=atol)
    x = torch.zeros_like(bf)
    unit, rnorm = _safe_normalize(Mf(bf))
    k = 0
    while k < maxiter:
        counts.host_reads += 1
        if not bool(rnorm > atol_t):
            break
        x, unit, rnorm = _gmres_restart(Af, Mf, bf, x, unit, rnorm, restart)
        counts.restarts += 1
        k += 1
    return x.reshape(shape)


# ---------------------------------------------------------------------------
# block-Jacobi
# ---------------------------------------------------------------------------

def _probe_blocks(f_lin: Callable, u, counts: KrylovCounts | None = None):
    """Per-cell diagonal blocks [M, n(row), n(col)] of a LINEAR cell-local
    operator f_lin, n = c*K, M the cells in C order: one application per
    local DoF index, seeded in every cell at once; by the DG operator's
    locality each cell's response is its own diagonal block
    (dflo_tpu/solver/implicit.py:101-121)."""
    c, K = u.shape[0], u.shape[1]
    sp = u.shape[2:]
    n = c * K
    cols = []
    for kk in range(n):
        tang = torch.zeros(n, dtype=u.dtype, device=u.device)
        tang[kk] = 1.0
        tang = tang.view(c, K, *([1] * len(sp))).expand(u.shape)
        cols.append(f_lin(tang.contiguous()))
        if counts is not None:
            counts.tangents += 1
    J = torch.stack(cols).reshape(n, n, -1)          # [col, row, M]
    return J.permute(2, 1, 0).contiguous()


def _blocks_minv(Jinv, u_shape):
    """v -> the batched per-cell block inverses [M, n, n] applied to v."""
    n = Jinv.shape[-1]

    def Minv(v):
        vb = v.reshape(n, -1).T                      # [M, n]
        out = torch.bmm(Jinv, vb[:, :, None])[:, :, 0]
        return out.T.reshape(u_shape)

    return Minv


def make_block_jacobi(f_lin: Callable, u, counts: KrylovCounts | None = None):
    """The exact per-cell diagonal blocks of the linearized Newton operator
    f_lin, probed and inverted (batched torch.linalg.inv): the matrix-free
    analog of the reference's block preconditioners (src/claw.cc:666-691)."""
    J = _probe_blocks(f_lin, u, counts)
    return _blocks_minv(torch.linalg.inv(J), u.shape)


def probe_rhs_blocks(rhs: Callable, u, t, counts: KrylovCounts | None = None):
    """Per-cell diagonal blocks of the SPATIAL operator dR/du at u, to lag
    the block-Jacobi preconditioner across steps: the probes are reused and
    only the I/dt - theta*J_R shift is rebuilt (_lagged_minv)."""
    return _probe_blocks(linearize(rhs, u, t), u, counts)


def _lagged_minv(jr_blocks, dtb, theta, u_shape, dtype):
    """Block-Jacobi inverse of I/dt - theta*J_R from lagged rhs blocks; dtb
    a scalar dt or a per-cell field over the spatial axes."""
    M, n, _ = jr_blocks.shape
    dt_flat = torch.as_tensor(dtb, dtype=dtype, device=jr_blocks.device)
    dt_flat = dt_flat.expand(u_shape[2:]).reshape(-1)
    eye = torch.eye(n, dtype=dtype, device=jr_blocks.device)
    J = eye[None] / dt_flat[:, None, None] - theta * jr_blocks
    return _blocks_minv(torch.linalg.inv(J), u_shape)


# ---------------------------------------------------------------------------
# the Newton step
# ---------------------------------------------------------------------------

def _norm_state(x):
    return torch.sqrt(torch.sum(x * x))


def make_implicit_step(rhs: Callable, theta: float = 1.0,
                       max_newton: int = 1, lin_tol: float = 1e-4,
                       gmres_restart: int = 30, gmres_maxiter: int = 10,
                       precondition: str | None = None,
                       post_update: Callable | None = None,
                       newton_atol: float = NEWTON_ATOL,
                       counts: KrylovCounts | None = None):
    """step(u_old, t, dt, u_guess=None, jr_blocks=None) -> (u, NewtonInfo)
    (dflo_tpu/solver/implicit.py:179-302).

    lin_tol: the relative Krylov tolerance (`linear solver residual`);
    max_newton: `nonlinear iterations`; dt a scalar (0-dim tensor or
    float) or a per-cell [ny, nx] field; precondition None or
    "block_jacobi"; post_update(u, t), the driver's stabilization chain
    after every Newton update.  u_guess: the Newton start (the driver's
    predictor 2u - u_old), default u_old; jr_blocks: lagged dR/du blocks
    (probe_rhs_blocks), with which block-Jacobi rebuilds only the dt shift.
    rhs(u, t) gives the primal; its tangent comes from linearize(rhs).
    counts (KrylovCounts, ``step.counts``) accumulates what the steps did."""
    counts = counts if counts is not None else KrylovCounts()

    def step(u_old, t, dt, u_guess=None, jr_blocks=None):
        dtb = torch.as_tensor(dt, dtype=u_old.dtype, device=u_old.device)
        dt_raw = dtb
        if dtb.dim() > 0:
            dtb = dtb[None, None]            # per-cell field over (c, K)
        u0 = u_old if u_guess is None else u_guess

        def blend(v):
            return theta * v + (1.0 - theta) * u_old

        def F(v):
            counts.primals += 1
            return (v - u_old) / dtb - rhs(blend(v), t)

        M_lagged = None
        if precondition == "block_jacobi" and jr_blocks is not None:
            M_lagged = _lagged_minv(jr_blocks, dt_raw, theta, u_old.shape,
                                    u_old.dtype)

        def newton_update(u, Fv):
            JR = linearize(rhs, blend(u), t)

            def Av(dv):
                counts.tangents += 1
                return dv / dtb - JR(theta * dv)

            if M_lagged is not None:
                M = M_lagged
            elif precondition == "block_jacobi":
                M = make_block_jacobi(Av, u)
            else:
                M = None
            du = gmres(Av, -Fv, M, tol=lin_tol, atol=0.0,
                       restart=gmres_restart, maxiter=gmres_maxiter,
                       counts=counts)
            # the achieved relative linear residual in the left-
            # preconditioned norm, the one gmres's own test uses
            rvec = Av(du) + Fv
            Fn = Fv
            if M is not None:
                rvec, Fn = M(rvec), M(Fv)
            lin_res = _norm_state(rvec) / torch.clamp(_norm_state(Fn),
                                                      min=1e-300)
            u = u + du
            if post_update is not None:
                u = post_update(u, t)
            counts.newton += 1
            return u, lin_res

        if max_newton == 1:
            # `nonlinear iterations = 1`: one straight-line update
            Fv = F(u0)
            res0 = _norm_state(Fv)
            u, lin_res = newton_update(u0, Fv)
            iters = 1
            div = torch.zeros((), dtype=torch.bool, device=u_old.device)
        else:
            # the reference's loop (src/claw.cc:892-930): assemble, test,
            # solve, update, limit; it continues while it < max_newton,
            # the residual assembled at the top of the last iteration is
            # above newton_atol and nothing diverged
            u, iters = u0, 0
            res_prev = math.inf
            res0 = None
            div = False
            lin_res = torch.zeros((), dtype=u_old.dtype, device=u_old.device)
            while iters < max_newton and res_prev > newton_atol and not div:
                Fv = F(u)
                res = _norm_state(Fv)
                res0 = res if res0 is None else res0
                div_t = ~torch.isfinite(res) | (
                    res > DIVERGENCE_FACTOR * torch.clamp(res0, min=1e-300))
                counts.host_reads += 1
                res_prev, div = torch.stack([res,
                                             div_t.to(res.dtype)]).tolist()
                div = bool(div)
                if not div:
                    u, lin_res = newton_update(u, Fv)
                iters += 1
            div = torch.tensor(div, device=u_old.device)

        final = _norm_state(F(u))
        diverged = div | ~torch.isfinite(final) | (
            final > DIVERGENCE_FACTOR * torch.clamp(res0, min=1e-300))
        return u, NewtonInfo(res0, final, torch.tensor(iters), diverged,
                             lin_res)

    step.counts = counts
    return step


# ---------------------------------------------------------------------------
# steady solves
# ---------------------------------------------------------------------------

def run_steady(solver, u, cfl0: float | None = None,
               min_residual: float = 1e-10, max_steps: int = 2000,
               verbose: bool = False, jacobi_lag: int = 1):
    """Pseudo-transient continuation to steady state
    (dflo_tpu/solver/implicit.py:305-396): local per-cell dt,
    backward-Euler Newton steps, the CFL ramped by the residual-history
    factor clamped to [0.5, 2] (src/claw.cc:1079-1090).

    `solver` is a driver.Solver built with method="implicit"; on a
    curvilinear block each cell's dt is h/(|v| + c)/(2p + 1) with h from
    mesh.cell_h, as the reference's.  Newton
    divergence raises FloatingPointError (src/claw.cc:919-923); a
    non-converged linear solve warns and continues (src/claw.cc:677-687).
    The steady residual is ||R(u)|| of the new state through the solver's
    rhs (the kernel's R form on the fused path).  jacobi_lag > 1 with
    block-Jacobi re-probes dR/du only every jacobi_lag steps.  The run
    stops below min_residual or when ||R|| has not improved by 0.1 % in
    100 steps (f32) or 500 (f64), its precision floor.  One host read per
    step.  Returns (u, residual history)."""
    cfl = cfl0 if cfl0 is not None else solver.cfl
    history = []
    step = solver._implicit_step
    counts = step.counts
    lin_tol = getattr(solver, "linear_residual", 1e-4)
    use_lag = (jacobi_lag > 1
               and getattr(solver, "precondition", None) == "block_jacobi")

    curvi = getattr(solver, "curvilinear", False)
    if curvi:
        # a curvilinear block's per-cell h (dflo_tpu/solver/implicit.py:
        # 329-345)
        h_field = torch.as_tensor(solver.mesh.cell_h()).to(
            dtype=u.dtype, device=u.device)

    def one(u, cfl, jr=None):
        ubar = solver.cell_averages(u)
        if curvi:
            lam = euler.max_eigenvalue(ubar)
            dtc = h_field / lam / (2.0 * solver.basis.degree + 1.0)
        else:
            dtc = rk_mod.local_dt(ubar, solver.mesh, solver.basis.degree,
                                  1.0)
        u_new, info = step(u, 0.0, dtc * cfl, jr_blocks=jr)
        counts.primals += 1
        res = torch.sqrt(torch.sum(solver.rhs(u_new, 0.0) ** 2))
        return u_new, res, info.diverged, info.lin_res

    jr = None
    best = float("inf")
    best_it = 0
    stag_window = 100 if u.dtype != torch.float64 else 500
    for it in range(max_steps):
        if use_lag and it % jacobi_lag == 0:
            jr = probe_rhs_blocks(solver.rhs, u, 0.0, counts)
        u, res, diverged, lin_res = one(u, cfl, jr)
        counts.host_reads += 1
        res, diverged, lin_res = torch.stack(
            [res, diverged.to(res.dtype), lin_res.to(res.dtype)]).tolist()
        if diverged or not (res == res):
            raise FloatingPointError(
                f"Newton divergence at steady iteration {it} "
                f"(src/claw.cc:919-923 abort)")
        if lin_res > lin_tol * 1.001:
            print(f"  WARNING: linear solver did not converge at steady "
                  f"it={it} (achieved {lin_res:.2e} > {lin_tol:.0e})")
        if it >= 2:
            factor = min(max(history[-1] / res, 0.5), 2.0)
            cfl *= factor
        history.append(res)
        if verbose and it % 10 == 0:
            print(f"  steady it={it:5d} res={res:.3e} cfl={cfl:.2f} "
                  f"lin_res={lin_res:.1e}")
        if res < min_residual:
            break
        if res < best * (1.0 - 1e-3):
            best, best_it = res, it
        elif it - best_it >= stag_window:
            print(f"  steady: residual stagnant at {res:.3e} since "
                  f"it={best_it} (precision floor); stopping at it={it}")
            break
    return u, history


def run_steady_sequenced(solver, coarse_solver, u, *,
                         cfl0: float | None = None,
                         min_residual: float = 1e-10, max_steps: int = 2000,
                         coarse_residual: float | None = None,
                         coarse_max_steps: int | None = None,
                         verbose: bool = False, jacobi_lag: int = 1,
                         levels: list | None = None):
    """Grid-sequenced pseudo-transient continuation
    (dflo_tpu/solver/implicit.py:399-436): converge the 2x-coarsened
    companion first from the conservative L2 restriction of the fine
    start (amr.make_restrict), prolong the result exactly
    (amr.make_prolong) and finish on the fine mesh.  `levels`, when
    given, receives the two histories (coarse, fine).  Returns
    (u, coarse_history + fine_history)."""
    from dflo_tpu_torch.amr import make_prolong, make_restrict
    cr = (coarse_residual if coarse_residual is not None
          else max(min_residual * 1e2, 1e-8))
    cms = coarse_max_steps if coarse_max_steps is not None else max_steps
    uc = make_restrict(solver.basis, u.dtype, u.device)(u)
    if verbose:
        print("  [grid sequencing: 2x-coarse companion first]")
    uc, hc = run_steady(coarse_solver, uc, cfl0=cfl0, min_residual=cr,
                        max_steps=cms, verbose=verbose, jacobi_lag=jacobi_lag)
    uf = make_prolong(solver.basis, u.dtype, u.device)(uc)
    if verbose:
        print("  [grid sequencing: prolonged to the fine mesh]")
    u, hist = run_steady(solver, uf, cfl0=cfl0, min_residual=min_residual,
                         max_steps=max_steps, verbose=verbose,
                         jacobi_lag=jacobi_lag)
    if levels is not None:
        levels.extend([hc, hist])
    return u, hc + hist
