"""Time the Pk post's and the MOOD check's kernels (and, as a control, a
few forms of the post's and the modal positivity's) of two trees of the
port against each other on one GPU, in one run, and the Pk post's and
the check's two kernels (per cell and per tile) where their build-time
caps choose between them.

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR holds the tree of the commit to compare with (`git archive <commit> |
tar -x -C DIR`); the change is the tree this file lies in.  A first process
makes every input through the plain versions (no kernel runs) and saves
it; meanwhile each arm builds its own library from SOURCES alone (all
compiles started together).  Each arm is then timed twice, in processes of
its own (the two packages never share one), in the order parent, change,
tile, cell, cell, tile, change, parent:

- parent: DIR as it stands;
- change: this tree; it also times each form of the Pk post's tile
  kernel on every other tile it takes there (`name@TYxTX`), for the rule
  of ops/kernels.pk_post_tile;
- tile: this tree built with DFLO_PK_POST_CELL_MAX_P_F32 = _F64 = 0 and
  DFLO_CHECK_PER_CELL_F32 = _F64 = 0 (the tile kernels at every degree
  and in both dtypes), the P1-P3 Pk post forms and the check's;
- cell: the same with the Pk post's caps at 3 and the check's at 1 (the
  per-cell kernels at P1-P3 and in both dtypes), the same forms.

Per form and run: `call_ms`, the median CUDA-event time of one wrapper
call (chip_smoke.py's `ms`: the wrapper's host work before the launch
included), and `dev_ms`, the device time of the port's kernels per call in
a torch.profiler trace (traced again, up to three times, where a trace
dropped a launch; null, and the form marked `dev incomplete`, where all
three did); and whether each output equals the parent's bitwise.  It prints the card's name and power limit, one line per form,
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
        "tile": ("DFLO_PK_POST_CELL_MAX_P_F32=0",
                 "DFLO_PK_POST_CELL_MAX_P_F64=0",
                 "DFLO_CHECK_PER_CELL_F32=0", "DFLO_CHECK_PER_CELL_F64=0"),
        "cell": ("DFLO_PK_POST_CELL_MAX_P_F32=3",
                 "DFLO_PK_POST_CELL_MAX_P_F64=3",
                 "DFLO_CHECK_PER_CELL_F32=1", "DFLO_CHECK_PER_CELL_F64=1")}
ORDER = ("parent", "change", "tile", "cell", "cell", "tile", "change",
         "parent")
#: the sources an arm builds (the others' entry points answer as stubs)
SOURCES = ("fused_post.cu", "fused_modal_pos.cu", "fused_diag.cu",
           "fused_pk_post.cu", "fused_mood_check.cu")
REPS, WARM = 20, 3
#: the dynamic shared memory one block may take (csrc/tile.cuh MAX_SMEM)
MAX_SMEM = 232448

NX, NY = 1152, 288          # the DMR
VX = 2048                   # examples/vortex_system_pbc.prm, cut to VX^2
FS = (1920, 640)            # examples/forward_step_tpu.prm
RT = (1024, 3072)           # examples/rayleigh_taylor.prm

# (name, kind, dtype, maker, degree, with_diag); "capped": the P1-P3 Pk
# post forms and the check's, which every arm times
FORMS = (
    *((f"pkpost_dmr_p{p}_{tag}{'_diag' if diag else ''}", "pk_post", tag,
       "dmr_mood", p, diag)
      for tag in ("f32", "f64") for p in range(1, 7)
      for diag in (True, False)),
    *((f"pkpost_{m}_p2_f32{'_diag' if diag else ''}", "pk_post", "f32",
       f"{m}_mood", 2, diag) for m in ("rt", "fwd") for diag in (True, False)),
    *((f"check_dmr_p{p}_f32", "check", "f32", "dmr_mood", p, False)
      for p in range(2, 7)),
    ("check_dmr_p4_f64", "check", "f64", "dmr_mood", 4, False),
    ("check_rt_p2_f32", "check", "f32", "rt_mood", 2, False),
    # the control: rows 4 and 8, whose kernels this change leaves alone
    ("post_dmr_q2_f32", "post", "f32", "dmr", 2, True),
    ("post_dmr_q4_f32", "post", "f32", "dmr", 4, True),
    ("modal_dmr_p4_f32", "modal", "f32", "dmr_mood", 4, False),
    ("modal_rt_p2_f32", "modal", "f32", "rt_mood", 2, False),
)


def capped(form) -> bool:
    return form[1] == "check" or (form[1] == "pk_post" and form[4] <= 3)


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
    """(solver, base()): the solver of the form's path and base() its
    state (u, t, dt) through the plain versions."""
    from dflo_tpu_torch import cli, entry
    from dflo_tpu_torch.ops import kernels
    maker, p = form[3], form[4]

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
    if maker == "rt_mood":
        params, s = prm_solver(cs, cs.RT_PRM, dtype, dev,
                               (RT[0] // cut, RT[1] // cut),
                               cs.RT_MOOD_EDITS)
        return s, lambda: steps(s, cli.set_ic(params, s), 2)
    assert maker == "fwd_mood", maker
    params, s = prm_solver(cs, cs.FS_PRM, dtype, dev,
                           (FS[0] // cut, FS[1] // cut),
                           cs.pk_edits(2, "mood"))

    def fwd_state():
        # chip_smoke.fwd_pk_solver's state: the IC with 2 % noise on every
        # DoF and 0.3 % of the mean on the higher modes, solid cells pinned,
        # the plain modal positivity
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
        return u, 0.0, s.cfl / lam / (2.0 * s.basis.degree + 1.0)
    return s, fwd_state


def operators(kernels, form, s):
    """The operators the form's kernel reads.  The masked forward step runs
    no Pk post on its path (its post is the plain modal TVB chain), so its
    Pk post form takes the unmasked operators of its limiter settings."""
    kind, maker = form[1], form[3]
    if kind == "post":
        return s._post_ops
    if kind == "modal":
        return s.rhs.modal_ops
    if kind == "check":
        return s._mood_stage.cops
    if maker != "fwd_mood":
        return s._pk_post_ops
    cfg = s.limiter_cfg
    return kernels.pk_post_operators(s.basis, s.mesh, M=cfg.M, beta=cfg.beta,
                                     char_lim=cfg.char_lim, dtype=s.dtype,
                                     device=s.device)


def inputs(cs, kernels, form, s, u, t, dt) -> dict:
    """The form's inputs from its path's state (u, t, dt), through the
    plain versions: the post's state; the modal positivity's with pass 1's
    degree map (rt, fwd); the Pk post's with the shock plane of the cells a
    MOOD stage marks; the check's pass-1 inputs (the candidate u_c, the
    DMP bounds, the initial degree and limiter planes)."""
    kind, maker = form[1], form[3]
    if kind == "post" or (kind == "modal" and maker == "dmr_mood"):
        return {"u": u, "deg": None}
    tt = s._scalar(t)
    if kind == "pk_post":
        with cs.plain_versions(kernels):
            _, marked, _, _ = s._mood_stage(u, tt, dt)
        return {"u": u, "shock": marked.to(u.dtype) * 2.0}
    c1 = cs.cascade_pass1(kernels, s, u, tt, dt)
    if kind == "modal":
        return {"u": u, "deg": c1["deg1"]}
    return {k: c1[k] for k in ("u_c", "bmin", "bmax", "deg0", "lim0")}


def input_key(form) -> str:
    """The file of the form's inputs (the Pk post's two forms share one)."""
    _, kind, tag, maker, p, _ = form
    return f"{kind}_{maker}_p{p}_{tag}"


def call(kernels, form, ops, x):
    """One call of the form's wrapper on its inputs x."""
    kind, diag = form[1], form[5]
    if kind == "post":
        return kernels.fused_post(x["u"], ops, with_diag=diag)
    if kind == "modal":
        return kernels.fused_modal_pos(x["u"], ops, x["deg"])
    if kind == "pk_post":
        return kernels.fused_pk_post(x["u"], x["shock"], ops, with_diag=diag)
    return kernels.fused_mood_check(x["u_c"], x["bmin"], x["bmax"],
                                    x["deg0"], x["lim0"], ops)


#: each kind's tile rule in ops/kernels (absent in a tree without it)
RULES = {"post": "post_tile", "modal": "post_tile",
         "pk_post": "pk_post_tile", "check": "check_tile"}


def rule_tile(kernels, form, dtype):
    """The tile the form's rule picks, or None where the tree has none."""
    kind, p = form[1], form[4]
    rule = getattr(kernels, RULES[kind], None)
    if rule is None:
        return None
    if kind in ("post", "modal"):
        return rule(p, kind == "modal", dtype)
    return rule(p, dtype) if kind == "pk_post" else rule(dtype)


def other_tiles(kernels, form, dtype, tile) -> list:
    """Every other tile the Pk post's tile kernel takes at this form:
    shared memory within the card's."""
    kind, p = form[1], form[4]
    if kind == "pk_post" and tile != kernels.BLOCK:
        return [t for t in kernels.POST_TILES if t != tile
                and 0 < kernels.pk_post_smem(p, dtype, t) <= MAX_SMEM]
    return []


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
    """The Python mirrors of the arm's DFLO_PK_POST_CELL_MAX_P and
    DFLO_CHECK_PER_CELL defines."""
    if arm in ("tile", "cell"):
        import torch
        v = int(ARMS[arm][0][-1])
        kernels.PK_POST_CELL_MAX_P = {torch.float32: v, torch.float64: v}
        kernels.pk_post_tile.cache_clear()
        c = arm == "cell"
        kernels.CHECK_PER_CELL = {torch.float32: c, torch.float64: c}


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
    trace); a trace that dropped a launch would under-count, so it is
    taken again, up to three times; dev_ms None where none held one launch
    per call."""
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
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "dflo" in e.name]
        if len(us) == REPS:
            return (statistics.median(ts), 1e-3 * sum(us) / REPS,
                    len(us) / REPS)
    return statistics.median(ts), None, len(us) / REPS


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
        # one state per path, degree and dtype; each kind's inputs from it
        paths = {}
        for form in FORMS:
            paths.setdefault((form[3], form[4], form[2]), {}).setdefault(
                input_key(form), form)
        for (maker, p, tag), keys in paths.items():
            t0 = time.perf_counter()
            s, base = solver(cs, next(iter(keys.values())), dtypes[tag], dev,
                             cut)
            state = base()
            for key, form in keys.items():
                torch.save(inputs(cs, kernels, form, s, *state),
                           work / f"{key}.pt")
            print(f"prep {maker} p{p} {tag} ({', '.join(keys)}): "
                  f"{tuple(state[0].shape)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del s, base, state
            if dev == "cuda":
                torch.cuda.empty_cache()
        return
    # timing
    if dev == "cuda":
        use_subset(kernels, work, args.arm)
    pin_cells(kernels, args.arm)
    out, solvers = {}, {}
    for form in FORMS:
        if args.arm in ("tile", "cell") and not capped(form):
            continue
        name, kind, tag, maker, p, _ = form
        dtype = dtypes[tag]
        if (maker, p, tag) not in solvers:
            solvers.clear()
            if dev == "cuda":
                torch.cuda.empty_cache()
            solvers[(maker, p, tag)] = solver(cs, form, dtype, dev, cut)[0]
        ops = operators(kernels, form, solvers[(maker, p, tag)])
        x = torch.load(work / f"{input_key(form)}.pt", map_location=dev)
        rule = getattr(kernels, RULES[kind], None)
        tiles = [rule_tile(kernels, form, dtype)]
        if args.arm == "change":
            tiles += other_tiles(kernels, form, dtype, tiles[0])
        for i, tile in enumerate(tiles):
            if i:   # every other tile the kernel takes, for the rule
                setattr(kernels, RULES[kind], lambda *a, _t=tile: _t)
            res = call(kernels, form, ops, x)
            res = res if isinstance(res, tuple) else (res,)
            call_ms, dev_ms, n = time_call(
                lambda: call(kernels, form, ops, x), dev)
            key = name if i == 0 else f"{name}@{tile[0]}x{tile[1]}"
            out[key] = {"call_ms": round(call_ms, 4),
                        "dev_ms": None if dev_ms is None else round(dev_ms, 4),
                        "launches_per_call": n,
                        "tile": None if tile is None else list(tile),
                        "digest": digest(res)}
            if rule is not None:
                setattr(kernels, RULES[kind], rule)
            print(f"{args.arm} {key}: {out[key]}", flush=True)
        del x, ops
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
    """Per form: each arm's runs (call_ms, dev_ms, tile), whether every
    run has its device time and whether every output equals the parent's
    bitwise."""
    out = {}
    for key in runs["parent"][0]:   # the forms
        ref = runs["parent"][0][key]["digest"]
        row = {}
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
                            "tile": rs[0]["tile"],
                            "dev_complete": all(r["dev_ms"] is not None
                                                for r in rs),
                            "bitwise": all(r["digest"] == ref for r in rs)}
        out[key] = row
        print(f"{key:22s} " + "  ".join(
            f"{lab} {v['tile'] or 'cell'} call {v['call_ms']} dev "
            f"{v['dev_ms']}{'' if v['dev_complete'] else ' dev incomplete'}"
            f"{'' if v['bitwise'] else ' NOT BITWISE'}"
            for lab, v in row.items()), flush=True)
    return out


if __name__ == "__main__":
    main()
