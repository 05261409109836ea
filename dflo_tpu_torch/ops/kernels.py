"""The three hand-written CUDA kernels of the explicit RK/TVB step, their
plain PyTorch versions, launch counters and the nvcc loader.

=================  ==========================================  ====================
wrapper            TPU kernel it replaces                      CUDA source
=================  ==========================================  ====================
fused_residual     dflo_tpu/ops/pallas_kernels.py              csrc/fused_residual.cu
                   make_fused_residual (dense, collocated Qk)
fused_post         make_fused_post                             csrc/fused_post.cu
fused_diag         make_fused_diag                             csrc/fused_diag.cu
=================  ==========================================  ====================

Each wrapper takes its plain version for a tensor that lies on the CPU, and
for a CUDA tensor launches its kernel or raises: there is no fallback.  Each
counts its launches in ``<wrapper>.launches`` (only where the kernel is
launched), so a run can show that the main path went through the kernels.

The small operators go to the kernels as one device buffer per builder
(``residual_operators``, ``post_operators``, ``diag_operators``), built once
from the NumPy basis; the plain versions read the same buffer through views.

The kernels are built at first use: ``nvcc`` compiles ``csrc/*.cu`` (one
process per source, all started together) into one shared library under
``dflo_tpu_torch/_build/``, keyed by a hash of the sources and flags, and it
is loaded with ctypes.  Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply, basis_reduce
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.physics.fluxes import hllc
from dflo_tpu_torch.stab.indicator import make_shock_indicator
from dflo_tpu_torch.stab.limiter import make_tvb_limiter
from dflo_tpu_torch.stab.positivity import _pos_points, make_positivity_limiter

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: nvcc flags: Hopper (sm_90a), full IEEE arithmetic (no --use_fast_math)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
#: per-source extra flags: the post chain must round like its plain version
#: (no multiply-add contraction), so that float32 limiter decisions agree
NVCC_SOURCE_FLAGS = {"fused_post.cu": ("-fmad=false",)}

#: degrees the kernels are instantiated for
DEGREES = (1, 2, 3)

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_lib = None


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if Path(c).is_file():
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return found


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(repr((NVCC_FLAGS, NVCC_SOURCE_FLAGS)).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return srcs, h.hexdigest()[:16]


def build(ptxas_info: bool = False) -> tuple[Path, str]:
    """Compile csrc/*.cu into one shared library (if not built yet).

    Returns (path of the .so, compiler diagnostics).  ptxas_info=True adds
    ``-Xptxas -v`` (registers, spills and shared memory per kernel) to a
    fresh build."""
    srcs, key = _sources()
    so = BUILD_DIR / f"libdflo_kernels_{key}.so"
    if so.exists():
        return so, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_info else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS,
                                   *NVCC_SOURCE_FLAGS.get(s.name, ()), *extra,
                                   "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = []
        failed = []
        for s, pr in zip(srcs, procs):
            out, _ = pr.communicate()
            logs.append(f"== {s.name}\n{out}")
            if pr.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)
    return so, "\n".join(logs)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.dflo_num_blocks.argtypes = [ci, ci]
    lib.dflo_num_blocks.restype = ci
    lib.dflo_fused_residual.argtypes = [ci, ci] + [vp] * 9 + [ci, ci, vp]
    lib.dflo_fused_residual.restype = ci
    lib.dflo_fused_post.argtypes = ([ci, ci] + [vp] * 5 + [ci] * 7
                                    + [cd] * 9 + [vp])
    lib.dflo_fused_post.restype = ci
    lib.dflo_fused_diag.argtypes = [ci, ci] + [vp] * 4 + [ci, ci, cd, vp]
    lib.dflo_fused_diag.restype = ci
    _lib = lib
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _cuda_or_cpu(u: torch.Tensor, *others: torch.Tensor | None) -> bool:
    """True: launch the kernel; False: use the plain version.  Raises for a
    device or dtype the kernels do not take."""
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"tensors on {u.device} are not supported")
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernels take float32/float64, got {u.dtype}")
    for o in others:
        if o is None:
            continue
        if o.device != u.device or o.dtype != u.dtype:
            raise ValueError("all kernel operands must share u's device and "
                             "dtype")
        if not o.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    return True


def reset_launch_counts() -> None:
    for fn in (fused_residual, fused_post, fused_diag):
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches
            for fn in (fused_residual, fused_post, fused_diag)}


# ---------------------------------------------------------------------------
# operator buffers
# ---------------------------------------------------------------------------

def _check_basis(basis: basis_mod.Basis) -> None:
    if basis.family != "Qk" or not basis.is_nodal_collocated:
        raise NotImplementedError(
            "the kernels of this slice take the collocated nodal Qk basis "
            "(the modal Pk forms come with the MOOD slice)")
    if basis.degree not in DEGREES:
        raise NotImplementedError(
            f"the kernels are instantiated for degrees {DEGREES}, "
            f"got {basis.degree}")


def _flat(parts, dtype, device) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Concatenate float64 numpy parts into one device buffer and return it
    with a view per part (same shapes)."""
    arrs = [np.asarray(a, np.float64) for a in parts]
    buf = as_tensor(np.concatenate([a.ravel() for a in arrs]), dtype, device)
    views, off = [], 0
    for a in arrs:
        views.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return buf, views


@dataclasses.dataclass(frozen=True)
class ResidualOps:
    """Operators of the fused residual: faceV [4, nq, K] and
    lift [K, 2K + 4nq] = [dy*GxW^T | dx*GyW^T | +W | -E | +S | -N face lifts],
    rows pre-scaled by minv/area (pallas_kernels.py:642-660).  HLLC reads
    no cell averages, so the buffer carries none."""
    p: int
    K: int
    nq: int
    buf: torch.Tensor
    faceV: torch.Tensor
    lift: torch.Tensor


def residual_operators(basis: basis_mod.Basis, mesh, *, dtype, device
                       ) -> ResidualOps:
    _check_basis(basis)
    scale = (1.0 / basis.mass)[:, None] / (mesh.dx * mesh.dy)
    GxW = basis.wq2[:, None] * basis.Gx
    GyW = basis.wq2[:, None] * basis.Gy
    fvw = [basis.wq[:, None] * basis.faceV[f] for f in range(4)]
    lift = np.concatenate(
        [mesh.dy * GxW.T * scale, mesh.dx * GyW.T * scale,
         mesh.dy * fvw[0].T * scale, -mesh.dy * fvw[1].T * scale,
         mesh.dx * fvw[2].T * scale, -mesh.dx * fvw[3].T * scale], axis=1)
    buf, (faceV, lift_t) = _flat([basis.faceV, lift], dtype, device)
    return ResidualOps(basis.degree, basis.K, basis.nq, buf, faceV, lift_t)


@dataclasses.dataclass(frozen=True)
class PostOps:
    """Operators and parameters of the fused stabilization chain.

    buf holds faceV [4, nq, K], wq [nq], avg [K], gx [K], gy [K] (mean
    gradients), drx [K], dry [K] (node offsets from the cell centre) and
    P [Qp, K] (positivity points), the layout of PostOps in
    csrc/fused_post.cu (pallas_kernels.py:1167-1176 builds the same
    operators).  indicator, limit and positivity are the plain stab/*
    closures of the same chain, on the same operators."""
    p: int
    K: int
    nq: int
    buf: torch.Tensor
    avg: torch.Tensor
    comp: int
    char_lim: bool
    pos_lim: bool
    per_x: bool
    per_y: bool
    dx: float
    dy: float
    h: float
    diam_pow: float
    Mdx2: float
    beta: float
    indicator: object
    limit: object
    positivity: object


def post_operators(basis: basis_mod.Basis, mesh, *, indicator: str = "density",
                   M: float = 0.0, beta: float = 1.0, char_lim: bool = False,
                   pos_lim: bool = True, per_x: bool = False,
                   per_y: bool = False, dtype, device) -> PostOps:
    _check_basis(basis)
    h = mesh.diameter_h
    diam = float(np.sqrt(mesh.dx * mesh.dx + mesh.dy * mesh.dy))
    p = basis.degree
    buf, views = _flat(
        [basis.faceV, basis.wq, basis.wq2 @ basis.V, basis.wq2 @ basis.Gx,
         basis.wq2 @ basis.Gy, (basis.nodes[:, 0] - 0.5) * mesh.dx,
         (basis.nodes[:, 1] - 0.5) * mesh.dy,
         basis.eval_at(_pos_points(p))], dtype, device)
    ind = make_shock_indicator(basis, mesh, indicator, per_x, per_y,
                               dtype=dtype, device=device)
    lim = make_tvb_limiter(basis, mesh, M=M, beta=beta, char_lim=char_lim,
                           per_x=per_x, per_y=per_y, dtype=dtype,
                           device=device)
    pos = (make_positivity_limiter(basis, dtype=dtype, device=device)
           if pos_lim else None)
    return PostOps(p, basis.K, basis.nq, buf, views[2],
                   {"density": euler.RHO, "energy": euler.ENE}[indicator],
                   char_lim, pos_lim, per_x, per_y, mesh.dx, mesh.dy, h,
                   diam ** (0.5 * (p + 1)), M * h * h, beta, ind, lim, pos)


@dataclasses.dataclass(frozen=True)
class DiagOps:
    """Operators of the fused diagnostics: avg [K] and the CFL length h."""
    p: int
    K: int
    avg: torch.Tensor
    h: float


def diag_operators(basis: basis_mod.Basis, mesh, *, dtype, device) -> DiagOps:
    _check_basis(basis)
    return DiagOps(basis.degree, basis.K,
                   as_tensor(basis.wq2 @ basis.V, dtype, device),
                   mesh.diameter_h)


def _check_state(u: torch.Tensor, K: int) -> tuple[int, int]:
    if u.dim() != 4 or u.shape[0] != 4 or u.shape[1] != K:
        raise ValueError(f"state must be [4, {K}, ny, nx], got "
                         f"{tuple(u.shape)}")
    return u.shape[2], u.shape[3]


# ---------------------------------------------------------------------------
# fused residual
# ---------------------------------------------------------------------------

def fused_residual_plain(u, dfw, dfe, dfs, dfn, ops: ResidualOps, u_old=None,
                         sc=None):
    """Plain version of the fused residual: the periodic-wrap residual
    everywhere, plus the delta strips lifted into the edge columns and rows.
    With (u_old, sc = [a, dt]) it returns the SSP stage
    a*u_old + (1-a)*(u + dt*R), else R = M^{-1} R(u)."""
    faceV, lift = ops.faceV, ops.lift
    Fx = euler.flux_x(u)                    # collocated: nodes = quad points
    Fy = euler.flux_y(u)
    uW, uE, uS, uN = (basis_apply(faceV[f], u) for f in range(4))
    # west-face flux of every column: left state = the west neighbor's east
    # trace (periodic wrap); the east-face flux is the next column's west
    Fw = hllc(torch.roll(uE, 1, -1), uW, 1.0, 0.0)
    Fe = torch.roll(Fw, -1, -1)
    Fs = hllc(torch.roll(uN, 1, -2), uS, 0.0, 1.0)
    Fn = torch.roll(Fs, -1, -2)
    # boundary corrections at the global edge columns / rows
    Fw = torch.cat([Fw[..., :1] + dfw[..., None], Fw[..., 1:]], -1)
    Fe = torch.cat([Fe[..., :-1], Fe[..., -1:] + dfe[..., None]], -1)
    Fs = torch.cat([Fs[..., :1, :] + dfs[:, :, None], Fs[..., 1:, :]], -2)
    Fn = torch.cat([Fn[..., :-1, :], Fn[..., -1:, :] + dfn[:, :, None]], -2)
    R = basis_apply(lift, torch.cat([Fx, Fy, Fw, Fe, Fs, Fn], dim=1))
    if u_old is None:
        return R
    a, dt = sc[0], sc[1]
    return a * u_old + (1.0 - a) * (u + dt * R)


def fused_residual(u, dfw, dfe, dfs, dfn, ops: ResidualOps, u_old=None,
                   sc=None):
    """M^{-1} R(u) with the boundary delta strips (dfw/dfe [4, nq, ny],
    dfs/dfn [4, nq, nx]); with (u_old, sc = [a, dt] on u's device) the whole
    SSP stage.  CPU tensors: the plain version; CUDA tensors: the kernel."""
    ny, nx = _check_state(u, ops.K)
    if (u_old is None) != (sc is None):
        raise ValueError("u_old and sc go together")
    if not _cuda_or_cpu(u, dfw, dfe, dfs, dfn, u_old, sc, ops.buf):
        return fused_residual_plain(u, dfw, dfe, dfs, dfn, ops, u_old, sc)
    for s, n in ((dfw, ny), (dfe, ny), (dfs, nx), (dfn, nx)):
        if tuple(s.shape) != (4, ops.nq, n):
            raise ValueError(f"strip shape {tuple(s.shape)} != "
                             f"{(4, ops.nq, n)}")
    if sc is not None and tuple(sc.shape) != (2,):
        raise ValueError("sc must be [a, dt]")
    lib = _load()
    out = torch.empty_like(u)
    rc = lib.dflo_fused_residual(
        _DTYPE_CODE[u.dtype], ops.p, _ptr(u), _ptr(dfw), _ptr(dfe), _ptr(dfs),
        _ptr(dfn), _ptr(u_old), _ptr(sc), _ptr(ops.buf), _ptr(out), ny, nx,
        _stream(u.device))
    _check(rc, "fused_residual")
    fused_residual.launches += 1
    return out


fused_residual.launches = 0


# ---------------------------------------------------------------------------
# fused post
# ---------------------------------------------------------------------------

def _lam_minq(ubar, h: float):
    """(max over cells of (c+|vx|)/h + (c+|vy|)/h, min over cells of
    min(rho, p)) from cell averages, NaN-propagating (the diag of
    pallas_kernels.py:1434-1451 and :1697-1715)."""
    rho = ubar[euler.RHO]
    pre = euler.pressure(ubar)
    cs = torch.sqrt(euler.GAMMA * torch.abs(pre) / torch.abs(rho))
    vx = torch.abs(ubar[euler.MX] / rho)
    vy = torch.abs(ubar[euler.MY] / rho)
    lam = (cs + vx) / h + (cs + vy) / h
    return torch.amax(lam), torch.minimum(torch.amin(rho), torch.amin(pre))


def fused_post_plain(u, ops: PostOps, with_diag: bool = False):
    """Plain version of the fused post: the stab/* chain
    {cell averages -> KXRCF -> TVB -> positivity}, plus (lam_max, minq) of
    the cell averages with with_diag (the chain preserves cell means)."""
    ubar = basis_reduce(ops.avg, u)
    shock, _ = ops.indicator(u, ubar)
    u1 = ops.limit(u, ubar, shock)
    if ops.positivity is not None:
        u1 = ops.positivity(u1, ubar)
    if not with_diag:
        return u1
    return (u1, *_lam_minq(ubar, ops.h))


def fused_post(u, ops: PostOps, with_diag: bool = False):
    """One stage's stabilization chain; with_diag also returns the 0-dim
    tensors (lam_max, minq).  CPU tensors: the plain version; CUDA tensors:
    the kernel (per-block diag partials reduced here with amax/amin)."""
    ny, nx = _check_state(u, ops.K)
    if not _cuda_or_cpu(u, ops.buf):
        return fused_post_plain(u, ops, with_diag)
    lib = _load()
    out = torch.empty_like(u)
    lam_p = minq_p = None
    if with_diag:
        nb = lib.dflo_num_blocks(ny, nx)
        lam_p = torch.empty(nb, dtype=u.dtype, device=u.device)
        minq_p = torch.empty(nb, dtype=u.dtype, device=u.device)
    rc = lib.dflo_fused_post(
        _DTYPE_CODE[u.dtype], ops.p, _ptr(u), _ptr(ops.buf), _ptr(out),
        _ptr(lam_p), _ptr(minq_p), ny, nx, int(ops.per_x), int(ops.per_y),
        ops.comp, int(ops.char_lim), int(ops.pos_lim), ops.dx, ops.dy, ops.h,
        ops.h / ops.dx, ops.h / ops.dy, 1.0 / ops.h, ops.diam_pow, ops.Mdx2,
        ops.beta, _stream(u.device))
    _check(rc, "fused_post")
    fused_post.launches += 1
    if not with_diag:
        return out
    return out, torch.amax(lam_p), torch.amin(minq_p)


fused_post.launches = 0


# ---------------------------------------------------------------------------
# fused diag
# ---------------------------------------------------------------------------

def fused_diag_plain(u, ops: DiagOps):
    """Plain version of the fused diag: compute_dt's wave speed and the
    negativity min over the cell averages of u."""
    return _lam_minq(basis_reduce(ops.avg, u), ops.h)


def fused_diag(u, ops: DiagOps):
    """(lam_max, minq) as 0-dim tensors.  CPU tensors: the plain version;
    CUDA tensors: the kernel plus an amax/amin over its per-block partials."""
    ny, nx = _check_state(u, ops.K)
    if not _cuda_or_cpu(u, ops.avg):
        return fused_diag_plain(u, ops)
    lib = _load()
    nb = lib.dflo_num_blocks(ny, nx)
    lam_p = torch.empty(nb, dtype=u.dtype, device=u.device)
    minq_p = torch.empty(nb, dtype=u.dtype, device=u.device)
    rc = lib.dflo_fused_diag(_DTYPE_CODE[u.dtype], ops.p, _ptr(u),
                             _ptr(ops.avg), _ptr(lam_p), _ptr(minq_p), ny, nx,
                             ops.h, _stream(u.device))
    _check(rc, "fused_diag")
    fused_diag.launches += 1
    return torch.amax(lam_p), torch.amin(minq_p)


fused_diag.launches = 0
