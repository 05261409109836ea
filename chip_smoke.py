"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py

Phases (any failure raises, and the script then prints no result):

1. card and build: the card's name and power limit; nvcc builds
   dflo_tpu_torch/csrc/*.cu (timed).
2. each kernel against its plain PyTorch version on the card, on the
   1152 x 288 Q2 double-Mach-reflection (DMR) state after the initial
   post_stage and after 10 plain steps, in float32 and float64: both forms of
   the residual, the post with and without its diagnostics, the diag; CUDA
   event times (median of 20); the f64 free stream through the residual
   kernel; one NaN cell must trip the fatal flag.
3. the main path: entry._build(1152, 288, float32, cuda) and
   Solver._multi_step(50); every kernel launched, no plain version called,
   no fatal flag, finite state; DoF-updates/s.
4. the entry() analog at 128 x 24: one f64 step with the kernels against the
   plain step, on the card and on the CPU.

The last lines are the kernel table and the card as JSON.  The machine with
the card has no JAX: this script imports neither jax nor dflo_tpu.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

#: tolerances, relative to the plain version's largest magnitude per
#: component.  f64: round-off of a different summation order and FMA
#: contraction.  f32: the same, at f32 epsilon; the post may flip a
#: threshold decision (KXRCF > 1, change > 1e-10) in a few cells, which are
#: counted and bounded separately.
TOL = {torch.float64: {"fused_residual": 1e-11, "fused_post": 1e-11,
                       "fused_diag": 1e-11},
       torch.float32: {"fused_residual": 1e-5, "fused_post": 1e-4,
                       "fused_diag": 1e-5}}
MAX_FLIP_FRACTION = 1e-4          # 0.01 % of the cells
NX, NY = 1152, 288
MAIN_STEPS = 50

SOURCES = {
    "fused_residual": ("dflo_tpu_torch/csrc/fused_residual.cu",
                       "dflo_tpu/ops/pallas_kernels.py:617",
                       "dflo_tpu/ops/pallas_kernels.py:make_fused_residual"),
    "fused_post": ("dflo_tpu_torch/csrc/fused_post.cu",
                   "dflo_tpu/ops/pallas_kernels.py:1075",
                   "dflo_tpu/ops/pallas_kernels.py:make_fused_post"),
    "fused_diag": ("dflo_tpu_torch/csrc/fused_diag.cu",
                   "dflo_tpu/ops/pallas_kernels.py:1663",
                   "dflo_tpu/ops/pallas_kernels.py:make_fused_diag"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def rel_err(k: torch.Tensor, p: torch.Tensor) -> float:
    """max over components of max|k - p| / max|p| (component = leading axis
    for states, the whole tensor for scalars)."""
    k, p = k.double(), p.double()
    if k.dim() == 0:
        return float((k - p).abs() / p.abs().clamp(min=1e-300))
    num = (k - p).abs().flatten(1).amax(1)
    den = p.abs().flatten(1).amax(1).clamp(min=1e-300)
    return float((num / den).max())


def abs_err(k: torch.Tensor, p: torch.Tensor) -> float:
    return float((k.double() - p.double()).abs().max())


def post_err(k: torch.Tensor, p: torch.Tensor, tol: float):
    """(relative error outside flipped cells, number of flipped cells): a
    cell is flipped when its own error exceeds tol (a threshold decision of
    the limiter went the other way)."""
    k, p = k.double(), p.double()
    scale = p.abs().flatten(1).amax(1).clamp(min=1e-300)       # [4]
    cell = ((k - p).abs() / scale[:, None, None, None]).amax((0, 1))
    flipped = cell > tol
    return float(torch.where(flipped, 0.0, cell).max()), int(flipped.sum())


class PlainStage:
    """The fused residual's SSP stage through its plain version."""

    def __init__(self, solver):
        self.s = solver

    def stage(self, u, u_old, t, a, dt):
        from dflo_tpu_torch.ops import kernels
        sc = torch.stack([torch.full_like(dt, a), dt])
        return kernels.fused_residual_plain(u, *self.s.rhs.strips(u, t),
                                            self.s.rhs.ops, u_old=u_old, sc=sc)


def plain_step(s, u, t, t_end):
    """Solver._make_step()'s step with every kernel replaced by its plain
    version (the same control flow, for comparisons on one device)."""
    from dflo_tpu_torch.ops import kernels
    from dflo_tpu_torch.solver import rk as rk_mod
    from dflo_tpu_torch.stab.positivity import EPS
    t, t_end = s._scalar(t), s._scalar(t_end)
    lam, _ = kernels.fused_diag_plain(u, s._diag_ops)
    dt = torch.minimum(s.cfl / lam / (2.0 * s.basis.degree + 1.0), t_end - t)
    u, _lam, minq = rk_mod.ssp_rk_step(
        PlainStage(s), u, t, dt, s.ark, s.stage_times,
        post_stage=lambda v, tc: kernels.fused_post_plain(v, s._post_ops,
                                                          True),
        post_diag=True)
    return u, dt, ~(minq >= EPS)


def phase_kernels(entry, kernels, euler, results):
    """Phase 2 for both dtypes; fills results[name][...]."""
    from dflo_tpu_torch.driver import LimiterConfig, Solver
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.solver.spatial import BoundarySide
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        tol = TOL[dt]
        s, u0 = entry._build(NX, NY, dtype=dt, device="cuda")
        u_a = s.post_stage(u0)
        u_b, t = u_a, 0.0
        for _ in range(10):
            u_b, dtt, bad = plain_step(s, u_b, t, 1.0)
            t += float(dtt)
            assert not bool(bad), f"{tag}: plain steps tripped the fatal flag"
        ubar = s.cell_averages(u_b)
        shock, _ = s._post_ops.indicator(u_b, ubar)
        n_marked = int((shock > 1.0).sum())
        print(f"[{tag}] state after 10 plain steps: t={t!r}, "
              f"{n_marked} cells marked by KXRCF")
        assert n_marked > 0, "the indicator marks no cell"

        tt = torch.full((), t, dtype=dt, device="cuda")
        dtt = torch.full((), 1e-4, dtype=dt, device="cuda")
        sc = torch.stack([torch.full_like(dtt, 0.75), dtt])
        for label, u in (("post_stage", u_a), ("10 steps", u_b)):
            strips = s.rhs.strips(u, tt)
            ops = s.rhs.ops
            checks = {
                "fused_residual": [
                    (kernels.fused_residual(u, *strips, ops),
                     kernels.fused_residual_plain(u, *strips, ops)),
                    (kernels.fused_residual(u, *strips, ops, u_old=u_a, sc=sc),
                     kernels.fused_residual_plain(u, *strips, ops, u_old=u_a,
                                                  sc=sc))],
                "fused_diag": list(zip(kernels.fused_diag(u, s._diag_ops),
                                       kernels.fused_diag_plain(u,
                                                                s._diag_ops))),
            }
            pk = kernels.fused_post(u, s._post_ops, with_diag=True)
            pp = kernels.fused_post_plain(u, s._post_ops, with_diag=True)
            pk0 = kernels.fused_post(u, s._post_ops)
            torch.cuda.synchronize()
            for name, pairs in checks.items():
                e = max(rel_err(k, p) for k, p in pairs)
                a = max(abs_err(k, p) for k, p in pairs)
                r = results[name]
                r[f"max_rel_err_{tag}"] = max(r.get(f"max_rel_err_{tag}", 0), e)
                r[f"max_abs_err_{tag}"] = max(r.get(f"max_abs_err_{tag}", 0), a)
                print(f"[{tag}] {label}: {name} rel err {e:.3e} "
                      f"(tol {tol[name]:.0e})")
                assert e <= tol[name], f"{name} {tag} disagrees: {e}"
            e_in, n_flip = post_err(pk[0], pp[0], tol["fused_post"])
            e0_in, n_flip0 = post_err(pk0, pp[0], tol["fused_post"])
            e_diag = max(rel_err(pk[1], pp[1]), rel_err(pk[2], pp[2]))
            e = max(e_in, e0_in, e_diag)
            nflip = max(n_flip, n_flip0)
            r = results["fused_post"]
            r[f"max_rel_err_{tag}"] = max(r.get(f"max_rel_err_{tag}", 0), e)
            r[f"max_abs_err_{tag}"] = max(r.get(f"max_abs_err_{tag}", 0),
                                          abs_err(pk[0], pp[0]))
            r[f"flipped_cells_{tag}"] = max(r.get(f"flipped_cells_{tag}", 0),
                                            nflip)
            print(f"[{tag}] {label}: fused_post rel err {e:.3e} outside "
                  f"{nflip} flipped cells (tol {tol['fused_post']:.0e}); "
                  f"diag rel err {e_diag:.3e}")
            assert e <= tol["fused_post"], f"fused_post {tag} disagrees: {e}"
            if dt == torch.float64:
                assert nflip == 0, "f64 post flipped a limiter decision"
            else:
                assert nflip <= MAX_FLIP_FRACTION * NX * NY, \
                    f"too many flipped cells: {nflip}"

        # ---- times on the 10-step state (main-path forms) ----------------
        strips = s.rhs.strips(u_b, tt)
        ops = s.rhs.ops
        timings = {
            "fused_residual": (
                lambda: kernels.fused_residual(u_b, *strips, ops, u_old=u_a,
                                               sc=sc),
                lambda: kernels.fused_residual_plain(u_b, *strips, ops,
                                                     u_old=u_a, sc=sc)),
            "fused_post": (
                lambda: kernels.fused_post(u_b, s._post_ops, with_diag=True),
                lambda: kernels.fused_post_plain(u_b, s._post_ops,
                                                 with_diag=True)),
            "fused_diag": (
                lambda: kernels.fused_diag(u_b, s._diag_ops),
                lambda: kernels.fused_diag_plain(u_b, s._diag_ops)),
        }
        for name, (fk, fp) in timings.items():
            ms_k = time_ms(fk)
            ms_p = time_ms(fp)
            results[name][f"ms_{tag}"] = ms_k
            results[name][f"plain_ms_{tag}"] = ms_p
            print(f"[{tag}] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
                  f"at {NX}x{NY}")

        # ---- NaN must reach the fatal flag -------------------------------
        u_nan = u_b.clone()
        u_nan[:, :, NY // 2, NX // 3] = float("nan")
        _lam, minq = kernels.fused_diag(u_nan, s._diag_ops)
        _u, _lam2, minq2 = kernels.fused_post(u_nan, s._post_ops,
                                              with_diag=True)
        _u, _dt, bad, _st = s._make_step()(u_nan, 0.0, 1.0)
        from dflo_tpu_torch.stab.positivity import EPS
        flags = [bool(~(minq >= EPS)), bool(~(minq2 >= EPS)), bool(bad)]
        print(f"[{tag}] one NaN cell -> fatal flag (diag, post, step): {flags}")
        assert all(flags), "a NaN cell did not reach the fatal flag"

    # ---- f64 free stream through the residual kernel ---------------------
    # round-off in du/dt scales like |F|/dx: 1e-12 is held at 128 x 32 (the
    # CPU tests' bound), the full width to the same bound times nx / 128
    per = BoundarySide(euler.BC_PERIODIC)
    lim = LimiterConfig(type="TVB", shock_indicator="density", beta=2.0,
                        char_lim=True, pos_lim=True)
    basis = make_basis("Qk", 2)
    rho, vx, vy, p = 1.4, 0.7, -0.3, 1.0
    state = torch.tensor([rho * vx, rho * vy, rho,
                          p / (euler.GAMMA - 1.0)
                          + 0.5 * rho * (vx * vx + vy * vy)],
                         dtype=torch.float64, device="cuda")
    for nx, ny in ((128, 32), (NX, NY)):
        fs = Solver(basis, CartesianMesh(nx, ny, 0.0, 4.0, 0.0, 1.0),
                    dict(W=per, E=per, S=per, N=per), flux="hllc",
                    limiter=lim, cfl=0.5, dtype=torch.float64, device="cuda")
        u_fs = state[:, None, None, None].expand(4, basis.K, ny, nx)
        R = fs.rhs(u_fs.contiguous(), 0.0)
        torch.cuda.synchronize()
        fs_max = float(R.abs().max())
        bound = 1e-12 * (nx / 128)
        print(f"[f64] free stream {nx}x{ny}: max|du/dt| through "
              f"fused_residual {fs_max:.3e} (bound {bound:.1e})")
        assert fs_max < bound, "free stream not preserved"
        results[f"free_stream_f64_{nx}x{ny}"] = fs_max


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    from dflo_tpu_torch import entry
    from dflo_tpu_torch.ops import kernels
    from dflo_tpu_torch.physics import euler
    assert "jax" not in sys.modules and "dflo_tpu" not in sys.modules

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | python {sys.version.split()[0]}")

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    so, log = kernels.build(ptxas_info=True)
    build_s = time.perf_counter() - t0
    print(f"build: {so.name} in {build_s:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---- phase 2: kernels against plain versions ---------------------------
    results = {name: {} for name in SOURCES}
    phase_kernels(entry, kernels, euler, results)

    # ---- phase 3: the main path --------------------------------------------
    plain_calls = {"n": 0}
    for name in ("fused_residual_plain", "fused_post_plain",
                 "fused_diag_plain"):
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, **k):
            plain_calls["n"] += 1
            return _fn(*a, **k)
        setattr(kernels, name, counted)
    solver, u0 = entry._build(NX, NY, dtype=torch.float32, device="cuda")
    u = solver.post_stage(u0)
    multi = solver._multi_step(MAIN_STEPS)
    solver._multi_step(2)(u, 0.0, 1.0e3)            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    plain_calls["n"] = 0
    t0 = time.perf_counter()
    u1, t1, n_done, bad, _ = multi(u, 0.0, 1.0e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_done, bad = int(n_done), bool(bad)
    finite = bool(torch.isfinite(u1).all())
    print(f"main path: {n_done} steps to t={float(t1)!r} in {wall:.4f} s, "
          f"bad={bad}, finite={finite}, launches={counts}, "
          f"plain calls={plain_calls['n']}")
    assert n_done == MAIN_STEPS and not bad and finite
    assert all(v > 0 for v in counts.values()), counts
    assert plain_calls["n"] == 0, "the main path called a plain version"
    rate = 4 * solver.basis.K * NX * NY * MAIN_STEPS / wall
    print(json.dumps({"dmr_q2_rk_tvb_dof_updates_per_sec": rate,
                      "unit": "DoF-updates/s", "dtype": "float32",
                      "grid": [NX, NY], "steps": MAIN_STEPS,
                      "ms_per_step": 1e3 * wall / MAIN_STEPS,
                      "card": card}))

    # ---- phase 4: entry() analog, one f64 step ------------------------------
    fn, (ue, te, tend) = entry.entry(dtype=torch.float64, device="cuda")
    uk = fn(ue, te, tend)
    s_cpu, _ = entry._build(128, 24, dtype=torch.float64, device="cpu")
    s_gpu, _ = entry._build(128, 24, dtype=torch.float64, device="cuda")
    up_gpu, _, _ = plain_step(s_gpu, ue, te, tend)
    up_cpu, _, _ = plain_step(s_cpu, ue.cpu(), te.cpu(), tend.cpu())
    torch.cuda.synchronize()
    e_gpu, e_cpu = rel_err(uk, up_gpu), rel_err(uk.cpu(), up_cpu)
    print(f"entry() step 128x24 f64: kernels vs plain on the card {e_gpu:.3e},"
          f" vs plain on the CPU {e_cpu:.3e} (tol 1e-10)")
    assert e_gpu <= 1e-10 and e_cpu <= 1e-10

    # ---- result lines -----------------------------------------------------
    table = []
    for name, (src, line, tpu) in SOURCES.items():
        r = results[name]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "tpu_kernel": tpu, "launches": counts[name],
            "max_abs_err": r["max_abs_err_f32"],
            "max_abs_err_f64": r["max_abs_err_f64"],
            "max_rel_err_f32": r["max_rel_err_f32"],
            "max_rel_err_f64": r["max_rel_err_f64"],
            "ms": r["ms_f32"], "plain_ms": r["plain_ms_f32"],
            "ms_f64": r["ms_f64"], "plain_ms_f64": r["plain_ms_f64"],
            **({"flipped_cells_f32": r["flipped_cells_f32"]}
               if name == "fused_post" else {})})
    assert all(math.isfinite(v) for row in table for v in row.values()
               if isinstance(v, float))
    print(json.dumps({"build_s": build_s, "card": card,
                      **{k: v for k, v in results.items()
                         if k.startswith("free_stream")}}))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
