"""Time the diag's and the volume residual's kernels (rows 6 and 1; and, as
a control, a few forms of the post's and the modal positivity's, rows 4
and 8) of two trees of the port against each other on one GPU, in one
run, and the volume residual's two kernels (per cell and per tile) where
its build-time cap chooses between them.

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR holds the tree of the commit to compare with (`git archive <commit> |
tar -x -C DIR`); the change is the tree this file lies in.  A first process
makes the control forms' inputs through the plain versions (no kernel
runs) and saves them; meanwhile each arm builds its own library from
SOURCES alone (all compiles started together).  The diag's and the volume
residual's inputs are made in each timing process on the card from a
seed (torch alone: every arm gets the same bits).  Each arm is then timed
twice, in processes of its own (the two packages never share one), in the
order parent, change, tile, cell, cell, tile, change, parent:

- parent: DIR as it stands;
- change: this tree; it also times each diag form with a workspace for 2
  and for 8 blocks per SM (`name@bps<N>`; the kernel takes at most one
  wave of them), for the rule DIAG_BLOCKS_PER_SM;
- tile: this tree built with DFLO_VOLUME_CELL_MAX_P_F32 = _F64 = 0 (the
  tile kernel at every degree), the Q1-Q3 volume forms alone (f32, f64);
- cell: the same with both caps at 3 (the per-cell kernel at Q1-Q3).

Per form and run: `call_ms`, the median CUDA-event time of one wrapper
call (chip_smoke.py's `ms`: the wrapper's host work before the launch
included), `dev_ms`, the device time of the port's kernels per call in a
torch.profiler trace (traced again, up to three times, where a trace
dropped a launch; null, and the form marked `dev incomplete`, where all
three did), `all_dev_ms`, the device time of every kernel of the call (the
parent's diag adds its amax and amin over the partials), `bound_ms`, the
bytes the function must move over the H100's 3.35 TB/s; and whether each
output equals the parent's bitwise.  It prints the card's name and power
limit, one line per form, and the whole as one JSON line (also to FILE,
given `--out`).  `--small` cuts every grid by 16 and runs on the CPU
through the plain versions: a rehearsal of the script, whose times mean
nothing.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ARMS = {"parent": (), "change": (),
        "tile": ("DFLO_VOLUME_CELL_MAX_P_F32=0",
                 "DFLO_VOLUME_CELL_MAX_P_F64=0"),
        "cell": ("DFLO_VOLUME_CELL_MAX_P_F32=3",
                 "DFLO_VOLUME_CELL_MAX_P_F64=3")}
ORDER = ("parent", "change", "tile", "cell", "cell", "tile", "change",
         "parent")
#: the sources an arm builds (the others' entry points answer as stubs)
SOURCES = ("fused_post.cu", "fused_modal_pos.cu", "fused_diag.cu",
           "volume_residual.cu")
REPS, WARM = 20, 3
HBM_BPS = 3.35e12           # the H100 SXM's memory rate (bytes/s)

NX, NY = 1152, 288          # the DMR
VX = 2048                   # examples/isentropic_vortex.prm, cut to VX^2
FS = (1920, 640)            # examples/forward_step_tpu.prm
RT = (1024, 3072)           # examples/rayleigh_taylor.prm

# (name, kind, dtype, maker, basis (family, degree, nq), grid (nx, ny));
# "synthetic": an input made on the card from a seed in the timing process
# (the diag and the volume residual), else the path whose state the prep
# makes (the controls); "capped": the Q1-Q3 volume forms, which every arm
# times
FORMS = (
    ("diag_vortex_p2_f32", "diag", "f32", "synthetic", ("Pk", 2, None),
     (VX, VX)),
    ("diag_vortex_p4_f32", "diag", "f32", "synthetic", ("Pk", 4, None),
     (VX, VX)),
    ("diag_vortex_p4_f64", "diag", "f64", "synthetic", ("Pk", 4, None),
     (VX, VX)),
    ("diag_vortex_p6_f32", "diag", "f32", "synthetic", ("Pk", 6, None),
     (VX // 2, VX // 2)),
    ("diag_dmr_p2_f32", "diag", "f32", "synthetic", ("Pk", 2, None),
     (NX, NY)),
    ("diag_dmr_q2_f32", "diag", "f32", "synthetic", ("Qk", 2, None),
     (NX, NY)),
    ("diag_dmr_q4_f32", "diag", "f32", "synthetic", ("Qk", 4, None),
     (NX, NY)),
    ("diag_fwd_p2_f32_masked", "diag", "f32", "fwd_mask", ("Pk", 2, None),
     FS),
    ("diag_iso_gll2_f32", "diag", "f32", "synthetic", ("Qk_gll", 2, None),
     (VX, VX)),
    ("diag_vortex_q2oi_f32", "diag", "f32", "synthetic", ("Qk", 2, 4),
     (VX, VX)),
    *((f"volume_dmr_q{p}_f32", "volume", "f32", "synthetic", ("Qk", p, None),
       (NX, NY)) for p in range(1, 7)),
    *((f"volume_dmr_q{p}_f64", "volume", "f64", "synthetic", ("Qk", p, None),
       (NX, NY)) for p in (1, 2, 3, 4)),
    ("volume_fwd_q1_f32", "volume", "f32", "synthetic", ("Qk", 1, None), FS),
    # the control: rows 4 and 8, whose kernels this change leaves alone
    ("post_dmr_q2_f32", "post", "f32", "dmr", ("Qk", 2, None), (NX, NY)),
    ("post_dmr_q4_f32", "post", "f32", "dmr", ("Qk", 4, None), (NX, NY)),
    ("modal_dmr_p4_f32", "modal", "f32", "dmr_mood", ("Pk", 4, None),
     (NX, NY)),
    ("modal_rt_p2_f32", "modal", "f32", "rt_mood", ("Pk", 2, None), RT),
)


def capped(form) -> bool:
    return form[1] == "volume" and form[4][1] <= 3


def bound_ms(form) -> float | None:
    """The least time of the diag's and the volume residual's work on the
    H100: the bytes it must move (each input read once, each output written
    once) over the memory rate; both are bound by bytes.  The diag reads
    the planes its mean needs (mode 0 alone on Pk) and a mask byte."""
    from dflo_tpu_torch.ops.basis import make_basis
    _, kind, tag, maker, (fam, p, nq), (nx, ny) = form
    if kind not in ("diag", "volume"):
        return None
    size = 4 if tag == "f32" else 8
    K = make_basis(fam, p, nq).K
    n = nx * ny
    if kind == "volume":
        return 1e3 * 8 * K * size * n / HBM_BPS
    planes = 4 if fam == "Pk" else 4 * K
    return 1e3 * (planes * size * n + (n if maker == "fwd_mask" else 0)) \
        / HBM_BPS


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------

def prm_solver(cs, path, dtype, dev, grid, edits=()):
    """(params, solver) of a .prm config at grid (nx, ny) with text edits."""
    from dflo_tpu_torch import cli
    from dflo_tpu_torch.config.params import AllParameters
    with tempfile.TemporaryDirectory() as tmp:
        prm = cs.edit_prm(str(HERE / path), os.path.join(tmp, "c.prm"),
                          *grid, *edits)
        params = AllParameters.from_prm_file(prm)
    s, _ = cli.build_solver(params, dtype=dtype, device=dev)
    return params, s


def solver(cs, form, dtype, dev, cut):
    """(solver, base()) of a control form: the solver of the form's path
    and base() its state (u, t, dt) through the plain versions."""
    from dflo_tpu_torch import cli, entry
    from dflo_tpu_torch.ops import kernels
    maker, p = form[3], form[4][1]

    def steps(s, u, n, t_end=1.0):
        t, dt = 0.0, None
        with cs.plain_versions(kernels):
            u = s.post_stage(u)
            for _ in range(n):
                u, dt, bad, _ = s._step(u, t, t_end)
                t += float(dt)
                assert not bool(bad), (form[0], "a plain step tripped bad")
        return u, t, dt

    if maker in ("dmr", "dmr_mood"):
        s, u0 = entry._build(NX // cut, NY // cut, dtype=dtype, device=dev,
                             degree=p,
                             method="mood" if maker == "dmr_mood" else "rk")
        return s, lambda: steps(s, u0, 2 if maker == "dmr" else 1)
    assert maker == "rt_mood", maker
    params, s = prm_solver(cs, cs.RT_PRM, dtype, dev,
                           (RT[0] // cut, RT[1] // cut), cs.RT_MOOD_EDITS)
    return s, lambda: steps(s, cli.set_ic(params, s), 2)


def synthetic(form, dtype, dev, cut, seed):
    """The diag's or the volume residual's state [4, K, ny, nx] on the
    device, from a seed: the DMR's post-shock state, 2 % noise on every
    nodal value, or on a modal basis the means with 2 % noise and the
    higher modes 1 % of the mean (torch alone: the same bits in every
    arm)."""
    import torch

    from dflo_tpu_torch.ops.basis import make_basis
    fam, p, nq = form[4]
    nx, ny = (max(1, n // cut) for n in form[5])
    K = make_basis(fam, p, nq).K
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = 2.0 * torch.rand((4, K, ny, nx), generator=g, dtype=dtype,
                             device=dev) - 1.0
    mean = torch.tensor([8.25 * 0.866, -8.25 * 0.5, 8.0, 563.5],
                        dtype=dtype, device=dev)[:, None, None, None]
    if fam != "Pk":
        return (mean * (1.0 + 0.02 * noise)).contiguous()
    noise[:, :1] = mean * (1.0 + 0.02 * noise[:, :1])
    noise[:, 1:] *= 0.01 * mean
    return noise.contiguous()


def operators(cs, kernels, form, dtype, dev, cut):
    """The operators the form's kernel reads: the diag's DiagOps (the
    masked forward step's from its solver), the volume residual's lift
    (make_rhs with volume_kernel="pallas"), the controls' from their
    solver (made again here, without its state)."""
    from dflo_tpu_torch.mesh import CartesianMesh
    from dflo_tpu_torch.ops.basis import make_basis
    from dflo_tpu_torch.solver.spatial import BoundarySide, make_rhs
    from dflo_tpu_torch.physics import euler
    kind, maker = form[1], form[3]
    if kind in ("post", "modal"):
        s = solver(cs, form, dtype, dev, cut)[0]
        return s._post_ops if kind == "post" else s.rhs.modal_ops
    nx, ny = (max(1, n // cut) for n in form[5])
    basis = make_basis(*form[4])
    if maker == "fwd_mask":
        _, s = prm_solver(cs, cs.FS_PRM, dtype, dev, (nx, ny),
                          cs.pk_edits(2, "rk3"))
        assert s.mask is not None and s._diag_ops.K == basis.K
        return s._diag_ops
    x1, y1 = (3.0, 1.0) if form[5] == FS else (4.0, 1.0)
    mesh = CartesianMesh(nx, ny, 0.0, x1, 0.0, y1)
    if kind == "diag":
        return kernels.diag_operators(basis, mesh, dtype=dtype, device=dev)
    side = BoundarySide(euler.BC_OUTFLOW)
    return make_rhs(basis, mesh, {k: side for k in "WESN"}, dtype=dtype,
                    device=dev, volume_kernel="pallas").lift_stack


def inputs(cs, kernels, form, s, u, t, dt) -> dict:
    """A control form's inputs from its path's state (u, t, dt), through
    the plain versions: the post's state; the modal positivity's with
    pass 1's degree map (rt)."""
    kind, maker = form[1], form[3]
    if kind == "post" or maker == "dmr_mood":
        return {"u": u, "deg": None}
    c1 = cs.cascade_pass1(kernels, s, u, s._scalar(t), dt)
    return {"u": u, "deg": c1["deg1"]}


def call(kernels, form, ops, x):
    """One call of the form's wrapper on its inputs x."""
    kind = form[1]
    if kind == "post":
        return kernels.fused_post(x["u"], ops, with_diag=True)
    if kind == "modal":
        return kernels.fused_modal_pos(x["u"], ops, x["deg"])
    if kind == "diag":
        return kernels.fused_diag(x["u"], ops)
    return kernels.volume_residual(ops, x["u"])


def variants(kernels, form, dtype, ops, u):
    """[(label, ops)] of the change arm's other settings of a diag form: a
    workspace for 2 and for 8 blocks per SM (bps<N>; the kernel takes at
    most one wave of them)."""
    import dataclasses

    import torch
    kind = form[1]
    if kind != "diag" or u.device.type != "cuda":
        return []
    sms = torch.cuda.get_device_properties(u.device).multi_processor_count
    out = []
    for bps in (2, 8):
        if bps == kernels.DIAG_BLOCKS_PER_SM:
            continue
        part, ticket = kernels.diag_workspace(u.shape[2], u.shape[3],
                                              dtype, u.device, sms * bps)
        out.append((f"bps{bps}",
                    dataclasses.replace(ops, part=part, ticket=ticket)))
    return out


# ---------------------------------------------------------------------------
# a subset library: the arm's sources of these kernels alone
# ---------------------------------------------------------------------------

class _Stub:
    """An entry point the subset library lacks."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args):
        raise RuntimeError(f"{self.name} is not in this build")


class _Lib:
    def __init__(self, path):
        self._lib = ctypes.CDLL(path)

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            stub = _Stub(name)
            setattr(self, name, stub)
            return stub


def use_subset(kernels, work: Path, arm: str) -> None:
    """Point the arm's kernels module at a build of SOURCES alone, with
    the arm's defines, under work/build_<arm>."""
    bdir = work / f"build_{arm}"
    src = bdir / "csrc"
    if not src.exists():
        src.mkdir(parents=True)
        for f in kernels.CSRC.iterdir():
            if f.suffix == ".cuh" or f.name in SOURCES:
                shutil.copy(f, src / f.name)
    kernels.CSRC, kernels.BUILD_DIR = src, bdir
    kernels.NVCC_FLAGS = (*kernels.NVCC_FLAGS,
                          *(f"-D{d}" for d in ARMS[arm]))
    kernels.ctypes = types.SimpleNamespace(
        CDLL=_Lib, c_void_p=ctypes.c_void_p, c_int=ctypes.c_int,
        c_double=ctypes.c_double)


def pin_cells(kernels, arm: str) -> None:
    """The Python mirror of the arm's DFLO_VOLUME_CELL_MAX_P defines."""
    if arm in ("tile", "cell"):
        import torch
        v = int(ARMS[arm][0][-1])
        kernels.VOLUME_CELL_MAX_P = {torch.float32: v, torch.float64: v}
        kernels.volume_tile.cache_clear()


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def digest(ts) -> str:
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def time_call(fn, dev) -> tuple[float, float | None, float, float | None]:
    """(call_ms, dev_ms, the port's kernels launched per call in the trace,
    all_dev_ms: every device kernel of the call); a trace that dropped a
    launch would under-count, so it is taken again, up to three times;
    dev_ms and all_dev_ms None where none held one launch per call."""
    import torch
    for _ in range(WARM):
        fn()
    if dev == "cpu":
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts), None, 0.0, None
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.time_range.elapsed_us() for e in evs if "dflo" in e.name]
        if len(us) == REPS:
            return (statistics.median(ts), 1e-3 * sum(us) / REPS,
                    len(us) / REPS, 1e-3 * sum(e.time_range.elapsed_us()
                                               for e in evs) / REPS)
    return statistics.median(ts), None, len(us) / REPS, None


def worker(args) -> None:
    sys.path.insert(0, str(Path(args.root).resolve()))
    import importlib.util

    import torch

    # this tree's chip_smoke.py for its helpers, against the arm's package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import dflo_tpu_torch
    from dflo_tpu_torch.ops import kernels
    assert Path(dflo_tpu_torch.__file__).resolve().is_relative_to(
        Path(args.root).resolve()), dflo_tpu_torch.__file__
    work = Path(args.work)
    dev = "cpu" if args.small else "cuda"
    cut = 16 if args.small else 1
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    if args.worker == "build":
        use_subset(kernels, work, args.arm)
        t0 = time.perf_counter()
        kernels.build()
        print(f"{args.arm}: built {', '.join(SOURCES)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return
    if args.worker == "prep":
        # the controls: one state per path, degree and dtype
        for form in FORMS:
            if form[3] in ("synthetic", "fwd_mask"):
                continue
            t0 = time.perf_counter()
            s, base = solver(cs, form, dtypes[form[2]], dev, cut)
            state = base()
            torch.save(inputs(cs, kernels, form, s, *state),
                       work / f"{form[0]}.pt")
            print(f"prep {form[0]}: {tuple(state[0].shape)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del s, base, state
            if dev == "cuda":
                torch.cuda.empty_cache()
        return
    # timing
    if dev == "cuda":
        use_subset(kernels, work, args.arm)
    pin_cells(kernels, args.arm)
    out = {}
    rule = getattr(kernels, "volume_tile", None)
    for i_form, form in enumerate(FORMS):
        if args.arm in ("tile", "cell") and not capped(form):
            continue
        name, kind, tag, maker, (fam, p, nq), _ = form
        dtype = dtypes[tag]
        if dev == "cuda":
            torch.cuda.empty_cache()
        ops = operators(cs, kernels, form, dtype, dev, cut)
        if maker in ("synthetic", "fwd_mask"):
            x = {"u": synthetic(form, dtype, dev, cut, 1000 + i_form)}
        else:
            x = torch.load(work / f"{form[0]}.pt", map_location=dev)
        if kind == "volume" and rule is not None:
            setting = f"x{rule((p + 1) ** 2, dtype)}"
        elif kind == "diag" and hasattr(kernels, "DIAG_BLOCKS_PER_SM"):
            setting = f"bps{kernels.DIAG_BLOCKS_PER_SM}"
        else:
            setting = None
        runs = [(name, setting, ops)]
        if args.arm == "change":
            runs += [(f"{name}@{lab}", lab, v) for lab, v in
                     variants(kernels, form, dtype, ops, x["u"])]
        for key, lab, o in runs:
            res = call(kernels, form, o, x)
            res = res if isinstance(res, tuple) else (res,)
            call_ms, dev_ms, n, all_ms = time_call(
                lambda: call(kernels, form, o, x), dev)
            out[key] = {"call_ms": round(call_ms, 4),
                        "dev_ms": None if dev_ms is None else round(dev_ms, 4),
                        "all_dev_ms": None if all_ms is None
                        else round(all_ms, 4),
                        "bound_ms": bound_ms(form),
                        "launches_per_call": n, "tile": lab,
                        "digest": digest(res)}
            print(f"{args.arm} {key}: {out[key]}", flush=True)
        del x, ops, res
    (work / f"time_{args.arm}_{args.run}.json").write_text(json.dumps(out))


def spawn(kind, arm, root, work, small, run=0):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", kind,
           "--arm", arm, "--root", str(root), "--work", str(work),
           "--run", str(run)] + (["--small"] if small else [])
    return subprocess.Popen(cmd, cwd=HERE)


def wait(procs) -> None:
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise SystemExit(f"a worker failed: {rcs}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent",
                    help="the tree to compare with (a git archive of it)")
    ap.add_argument("--out", help="also write the results' JSON here")
    ap.add_argument("--small", action="store_true",
                    help="grids cut by 16, on the CPU (a rehearsal)")
    ap.add_argument("--worker", choices=("prep", "build", "time"))
    ap.add_argument("--arm", choices=tuple(ARMS))
    ap.add_argument("--root")
    ap.add_argument("--work")
    ap.add_argument("--run", type=int, default=0)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    import torch
    if not args.small and not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA device (or --small)")
    if args.parent is None:
        ap.error("--parent is required")
    parent = Path(args.parent).resolve()
    assert (parent / "dflo_tpu_torch").is_dir(), parent
    roots = {a: parent if a == "parent" else HERE for a in ARMS}
    card = "cpu" if args.small else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    work = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    try:
        t0 = time.perf_counter()
        procs = [] if args.small else [
            spawn("build", a, roots[a], work, False) for a in ARMS]
        wait([spawn("prep", "change", HERE, work, args.small)] + procs)
        print(f"prep and builds {time.perf_counter() - t0:.1f} s", flush=True)
        runs = {a: [] for a in ARMS}
        for i, arm in enumerate(ORDER):
            wait([spawn("time", arm, roots[arm], work, args.small, i)])
            runs[arm].append(json.loads(
                (work / f"time_{arm}_{i}.json").read_text()))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = summarize(runs)
    doc = {"card": card, "reps": REPS, "forms": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))


def summarize(runs) -> dict:
    """Per form: each arm's runs (call_ms, dev_ms, all_dev_ms, the tile or
    grid setting), the bound, whether every run has its device time and
    whether every output equals the parent's bitwise."""
    out = {}
    for key in runs["parent"][0]:   # the forms
        ref = runs["parent"][0][key]["digest"]
        row = {"bound_ms": runs["parent"][0][key].get("bound_ms")}
        alts = sorted(k for k in runs["change"][0]
                      if k.startswith(f"{key}@"))
        for arm in ("parent", "change", "tile", "cell"):
            for k in (key, *(alts if arm == "change" else ())):
                rs = [r[k] for r in runs[arm] if k in r]
                if not rs:
                    continue
                lab = arm if k == key else k[len(key):]
                row[lab] = {"call_ms": [r["call_ms"] for r in rs],
                            "dev_ms": [r["dev_ms"] for r in rs],
                            "all_dev_ms": [r.get("all_dev_ms") for r in rs],
                            "tile": rs[0]["tile"],
                            "dev_complete": all(r["dev_ms"] is not None
                                                for r in rs),
                            "bitwise": all(r["digest"] == ref for r in rs)}
        out[key] = row
        print(f"{key:24s} bound {row['bound_ms']} " + "  ".join(
            f"{lab} {v['tile']} call {v['call_ms']} dev {v['dev_ms']} all "
            f"{v['all_dev_ms']}"
            f"{'' if v['dev_complete'] else ' dev incomplete'}"
            f"{'' if v['bitwise'] else ' NOT BITWISE'}"
            for lab, v in row.items() if lab != "bound_ms"), flush=True)
    return out


if __name__ == "__main__":
    main()
