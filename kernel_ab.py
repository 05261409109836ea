"""Time the post's and the modal positivity's kernels of two trees of the
port against each other on one GPU, in one run, and the post's two
kernels (per cell and per tile) at the degrees its launch table chooses
between.

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR holds the tree of the commit to compare with (`git archive <commit> |
tar -x -C DIR`); the change is the tree this file lies in.  A first process
makes every input through the plain versions (no kernel runs) and saves
it; meanwhile each arm builds its own library from the post's and the
modal positivity's sources alone (all compiles started together).  Each
arm is then timed twice, in processes of its own (the two packages never
share one), in the order parent, change, cell0, cell2, cell2, cell0,
change, parent:

- parent: DIR as it stands;
- change: this tree; it also times each form of the tile kernels on
  every other tile they take there (`name@TYxTX`), for the rule of
  ops/kernels.post_tile;
- cell0: this tree built with DFLO_POST_CELL_MAX_P_F32 = _F64 = 0 (the
  post's tile kernel at every degree), Q1-Q2 forms only;
- cell2: the same with both = 2 (the per-cell kernel at Q1-Q2 in both
  dtypes), Q1-Q2 forms only.

Per form and run: `call_ms`, the median CUDA-event time of one wrapper
call (chip_smoke.py's `ms`: the wrapper's host work before the launch
included), and `dev_ms`, the device time of the port's kernels per call in
a torch.profiler trace; and whether each output equals the parent's
bitwise.  It prints the card's name and power limit, one line per form,
and the whole as one JSON line (also to FILE, given `--out`).  `--small` cuts
every grid by 16 and runs on the CPU through the plain versions: a
rehearsal of the script, whose times mean nothing.
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
        "cell0": ("DFLO_POST_CELL_MAX_P_F32=0", "DFLO_POST_CELL_MAX_P_F64=0"),
        "cell2": ("DFLO_POST_CELL_MAX_P_F32=2", "DFLO_POST_CELL_MAX_P_F64=2")}
ORDER = ("parent", "change", "cell0", "cell2", "cell2", "cell0", "change",
         "parent")
#: the sources an arm builds (the others' entry points answer as stubs)
SOURCES = ("fused_post.cu", "fused_modal_pos.cu", "fused_diag.cu")
REPS, WARM = 20, 3
#: the dynamic shared memory one block may take (csrc/tile.cuh MAX_SMEM)
MAX_SMEM = 232448

NX, NY = 1152, 288          # the DMR
VX = 2048                   # examples/vortex_system_pbc.prm, cut to VX^2
FS = (1920, 640)            # examples/forward_step_tpu.prm
RT = (1024, 3072)           # examples/rayleigh_taylor.prm

# (name, kind, dtype, maker, degree, with_diag); "low": the Q1-Q2 post
# forms, which every arm times
FORMS = (
    *((f"post_dmr_q{p}_f32", "post", "f32", "dmr", p, True)
      for p in range(1, 7)),
    *((f"post_dmr_q{p}_f64", "post", "f64", "dmr", p, True)
      for p in range(1, 7)),
    ("post_pbc_q1_f32", "post", "f32", "pbc", 1, True),
    ("post_fwd_q1_f32", "post", "f32", "fwd", 1, True),
    *((f"modal_dmr_p{p}_f32", "modal", "f32", "dmr_mood", p, False)
      for p in range(2, 7)),
    ("modal_dmr_p4_f64", "modal", "f64", "dmr_mood", 4, False),
    ("modal_rt_p2_f32", "modal", "f32", "rt_mood", 2, False),
    ("modal_fwd_p2_f32", "modal", "f32", "fwd_mood", 2, False),
)


def low(form) -> bool:
    return form[1] == "post" and form[4] <= 2


# ---------------------------------------------------------------------------
# the inputs (the same code in every arm: the prep makes the states, the
# timing processes only the solvers whose operators the kernels read)
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
    """(solver, operators the form's kernel reads, make_state()): the
    solver of the form's path; make_state() its input (u, deg) through
    the plain versions."""
    from dflo_tpu_torch import cli, entry
    from dflo_tpu_torch.ops import kernels
    _, kind, _, maker, p, _ = form

    def steps(s, u, n, t_end=1.0):
        t, dt = 0.0, None
        with cs.plain_versions(kernels):
            u = s.post_stage(u)
            for _ in range(n):
                u, dt, bad, _ = s._step(u, t, t_end)
                t += float(dt)
                assert not bool(bad), (form[0], "a plain step tripped bad")
        return u, t, dt

    def pass1_degrees(s, u, t, dt):
        return cs.cascade_pass1(kernels, s, u, s._scalar(t), dt)["deg1"]

    if maker in ("dmr", "dmr_mood"):
        s, u0 = entry._build(NX // cut, NY // cut, dtype=dtype, device=dev,
                             degree=p,
                             method="mood" if maker == "dmr_mood" else "rk")
        if maker == "dmr":
            return s, s._post_ops, lambda: (steps(s, u0, 2)[0], None)
        return s, s._mood_stage.mops, lambda: (steps(s, u0, 1)[0], None)
    if maker in ("pbc", "fwd"):
        path, grid = ((cs.PBC_PRM, (VX, VX)) if maker == "pbc"
                      else (cs.FS_PRM, FS))
        params, s = prm_solver(cs, path, dtype, dev,
                               (grid[0] // cut, grid[1] // cut))
        return s, s._post_ops, lambda: (steps(
            s, cli.set_ic(params, s), 2, params.final_time)[0], None)
    if maker == "rt_mood":
        params, s = prm_solver(cs, cs.RT_PRM, dtype, dev,
                               (RT[0] // cut, RT[1] // cut),
                               cs.RT_MOOD_EDITS)

        def rt_state():
            u, t, dt = steps(s, cli.set_ic(params, s), 2)
            return u, pass1_degrees(s, u, t, dt)
        return s, s.rhs.modal_ops, rt_state
    assert maker == "fwd_mood", maker
    params, s = prm_solver(cs, cs.FS_PRM, dtype, dev,
                           (FS[0] // cut, FS[1] // cut),
                           cs.pk_edits(2, "mood"))

    def fwd_state():
        # chip_smoke.fwd_pk_solver's state: the IC with 2 % noise on every
        # DoF and 0.3 % of the mean on the higher modes, solid cells pinned,
        # the plain modal positivity; the degrees of its pass-1 check
        import torch
        u = cli.set_ic(params, s)
        g = torch.Generator(device=dev).manual_seed(102)
        u = u * (1.0 + 0.02 * (2.0 * torch.rand(
            u.shape, generator=g, dtype=dtype, device=dev) - 1.0))
        g = torch.Generator(device=dev).manual_seed(202)
        u[:, 1:] += 0.003 * u[:, :1] * (2.0 * torch.rand(
            u[:, 1:].shape, generator=g, dtype=dtype, device=dev) - 1.0)
        u = kernels.fused_modal_pos_plain(s.apply_mask(u.contiguous()),
                                          s.rhs.modal_ops)
        lam, _ = kernels.fused_diag_plain(u, s._diag_ops)
        dt = s.cfl / lam / (2.0 * s.basis.degree + 1.0)
        return u, pass1_degrees(s, u, 0.0, dt)
    return s, s.rhs.modal_ops, fwd_state


# ---------------------------------------------------------------------------
# a subset library: the arm's sources of these kernels alone
# ---------------------------------------------------------------------------

class _Stub:
    """An entry point the subset library lacks.  The parent tree's
    dflo_num_blocks (in its residual's source) is answered here: one diag
    partial per 4 x 32 block (csrc/euler.cuh BY x BX)."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args):
        if self.name == "dflo_num_blocks":
            ny, nx = args
            return -(-ny // 4) * -(-nx // 32)
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
    """The Python mirror of the arm's DFLO_POST_CELL_MAX_P defines."""
    if arm in ("cell0", "cell2"):
        import torch
        v = int(ARMS[arm][0][-1])
        kernels.POST_CELL_MAX_P = {torch.float32: v, torch.float64: v}
        kernels.post_tile.cache_clear()


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


def time_call(fn, dev) -> tuple[float, float | None, float]:
    """(call_ms, dev_ms, the port's kernels launched per call in the
    trace); dev_ms None unless the trace holds one launch per call."""
    import torch
    for _ in range(WARM):
        fn()
    if dev == "cpu":
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts), None, 0.0
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "dflo" in e.name]
    # a trace that dropped events would under-count: no device time then
    dev_ms = 1e-3 * sum(us) / REPS if len(us) == REPS else None
    return statistics.median(ts), dev_ms, len(us) / REPS


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
        for form in FORMS:
            t0 = time.perf_counter()
            _, _, make = solver(cs, form, dtypes[form[2]], dev, cut)
            u, deg = make()
            torch.save({"u": u, "deg": deg}, work / f"{form[0]}.pt")
            print(f"prep {form[0]}: {tuple(u.shape)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del u, deg
            if dev == "cuda":
                torch.cuda.empty_cache()
        return
    # timing
    if dev == "cuda":
        use_subset(kernels, work, args.arm)
    pin_cells(kernels, args.arm)
    out = {}
    for form in FORMS:
        if args.arm in ("cell0", "cell2") and not low(form):
            continue
        name, kind, tag, _, p, diag = form
        dtype = dtypes[tag]
        _, ops, _ = solver(cs, form, dtype, dev, cut)
        st = torch.load(work / f"{name}.pt", map_location=dev)
        u, deg = st["u"], st["deg"]

        def fn():
            if kind == "post":
                return kernels.fused_post(u, ops, with_diag=diag)
            return kernels.fused_modal_pos(u, ops, deg)
        tiles = [None]
        rule = getattr(kernels, "post_tile", None)
        if rule is not None:
            tiles = [rule(p, kind == "modal", dtype)]
            if args.arm == "change" and tiles[0] != kernels.BLOCK:
                tiles += [t for t in kernels.POST_TILES if t != tiles[0]
                          and takes(kernels, ops, kind, dtype, t)]
        for i, tile in enumerate(tiles):
            if i:   # every other tile the kernel takes, for the rule
                kernels.post_tile = lambda *a, _t=tile: _t
            res = fn()
            res = res if isinstance(res, tuple) else (res,)
            call_ms, dev_ms, n = time_call(fn, dev)
            key = name if i == 0 else f"{name}@{tile[0]}x{tile[1]}"
            out[key] = {"call_ms": round(call_ms, 4),
                        "dev_ms": None if dev_ms is None else round(dev_ms, 4),
                        "launches_per_call": n,
                        "tile": None if tile is None else list(tile),
                        "digest": digest(res)}
            kernels.post_tile = rule
            print(f"{args.arm} {key}: {out[key]}", flush=True)
        del st, u, deg, ops
        if dev == "cuda":
            torch.cuda.empty_cache()
    (work / f"time_{args.arm}_{args.run}.json").write_text(json.dumps(out))


def takes(kernels, ops, kind, dtype, tile) -> bool:
    """Whether the tile kernel takes tile at this form: a thread per cell
    (the post's chain two) and the shared memory within the card's."""
    modal = kind == "modal"
    cells = tile[0] * tile[1]
    b = (kernels.post_smem(ops.p, True, dtype, tile) if modal else
         kernels.post_smem(ops.p, False, dtype, tile, ops.vflags is not None,
                           ops.pos_lim))
    return cells * (1 if modal else 2) <= kernels.TILE_THREADS and \
        0 < b <= MAX_SMEM


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
    """Per form: each arm's runs (call_ms, dev_ms, tile) and whether every
    output equals the parent's bitwise."""
    out = {}
    for key in runs["parent"][0]:   # the forms
        ref = runs["parent"][0][key]["digest"]
        row = {}
        alts = sorted(k for k in runs["change"][0]
                      if k.startswith(f"{key}@"))
        for arm in ("parent", "change", "cell0", "cell2"):
            for k in (key, *(alts if arm == "change" else ())):
                rs = [r[k] for r in runs[arm] if k in r]
                if not rs:
                    continue
                lab = arm if k == key else k[len(key):]
                row[lab] = {"call_ms": [r["call_ms"] for r in rs],
                            "dev_ms": [r["dev_ms"] for r in rs],
                            "tile": rs[0]["tile"],
                            "bitwise": all(r["digest"] == ref for r in rs)}
        out[key] = row
        print(f"{key:22s} " + "  ".join(
            f"{lab} {v['tile'] or 'cell'} call {v['call_ms']} dev "
            f"{v['dev_ms']}{'' if v['bitwise'] else ' NOT BITWISE'}"
            for lab, v in row.items()), flush=True)
    return out


if __name__ == "__main__":
    main()
