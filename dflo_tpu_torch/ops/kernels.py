"""The hand-written CUDA kernels of the port, their plain PyTorch versions,
launch counters and the nvcc loader.

=====================  ==========================================  ==========================
wrapper                TPU kernel it replaces                      CUDA source
                       (dflo_tpu/ops/pallas_kernels.py)
=====================  ==========================================  ==========================
fused_residual         make_fused_residual, dense (collocated Qk   csrc/fused_residual.cu
                       and GLL, modal Pk and over-integrated       csrc/fused_residual_lxf.cu
                       nodal bases, degrees 1-6; hllc, lxf, roe,   csrc/fused_residual_{roe,
                       sw, kfvs and kep; a solid-cell mask on      sw,kfvs,kep}.cu
                       every basis; its ops["src"] and wb_iso      csrc/fused_residual_src*.cu
                       source arms, with every flux)               csrc/fused_residual_planes*.cu
                                                                   csrc/fused_residual_wb*.cu
fused_mood_candidate   make_fused_residual(...).sparse (hllc,      csrc/fused_mood_candidate.cu
                       lxf, roe, sw, kfvs and kep; any modal Pk    csrc/fused_mood_candidate_{lxf,
                       basis of degree 1-6, over-integrated too)   roe,sw,kfvs,kep}.cu
fused_post             make_fused_post; with halo lines, the       csrc/fused_post.cu
                       per-device kernel of
                       make_fused_post_sharded
fused_diag             make_fused_diag                             csrc/fused_diag.cu
fused_diag_sharded     make_fused_diag_sharded                     csrc/fused_diag.cu
fused_modal_pos        make_fused_modal_pos                        csrc/fused_modal_pos.cu
fused_pk_post          make_fused_pk_post                          csrc/fused_pk_post.cu
fused_mood_check       make_fused_mood_check                       csrc/fused_mood_check.cu
volume_residual        volume_residual                             csrc/volume_residual.cu
=====================  ==========================================  ==========================

Each wrapper takes its plain version for a tensor that lies on the CPU, and
for a CUDA tensor launches its kernel or raises: there is no fallback.  Each
counts its launches in ``<wrapper>.launches`` (only where the kernel is
launched), so a run can show that the main path went through the kernels;
the residual and the candidate also count per form (``launch_counts``).
Under a device mesh the state is a list of blocks (parallel/sharding):
``fused_post_sharded`` exchanges the halo lines and launches the post's
block form once per block (counted in ``fused_post.launches`` and
``fused_post.launches_block``), ``fused_diag_sharded`` the diag once per
block; both reduce the per-block (lam, minq) on the first block's device.

The small operators go to the kernels as device buffers built once from the
NumPy basis (``residual_operators``, ``post_operators``, ``diag_operators``,
``modal_operators``, ``pk_post_operators``, ``mood_check_operators``); the
plain versions read the same buffers through views.

The kernels are built at first use: ``nvcc`` compiles ``csrc/*.cu`` (one
process per source, all started together) into one shared library under
``dflo_tpu_torch/_build/``, keyed by a hash of the sources and flags, and it
is loaded with ctypes.  Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.contract import (as_tensor, basis_apply1,
                                         basis_apply_ordered, basis_reduce,
                                         recip)
from dflo_tpu_torch.parallel.sharding import (DeviceMesh, exchange_halos,
                                              reduce_max, reduce_min)
from dflo_tpu_torch.physics import euler
from dflo_tpu_torch.physics.fluxes import get_flux
from dflo_tpu_torch.stab import mood as mood_mod
from dflo_tpu_torch.stab.indicator import make_shock_indicator
from dflo_tpu_torch.stab.limiter import make_tvb_limiter, neighbor_valid
from dflo_tpu_torch.stab.positivity import _pos_points, make_positivity_limiter

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: nvcc flags: Hopper (sm_90a), full IEEE arithmetic (no --use_fast_math)
#: and no multiply-add contraction (-fmad=false): every kernel performs its
#: plain version's IEEE operations in the plain version's order, so the two
#: take the same threshold decisions (the TVB gate change > 1e-10, the
#: positivity branches at the pressure floor, the MOOD check) in both dtypes
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

#: degrees every kernel takes (the residual, post, diag, volume_residual
#: and the MOOD kernels: the candidate, modal positivity, Pk post and, from
#: p = 2, the check): 1-3 with an instantiation each, 4-6 on the general
#: dims (csrc/euler.cuh GDims), as the reference's bases run to degree 6
DEGREES = (1, 2, 3, 4, 5, 6)
#: the quadrature bound of the general dims (csrc/euler.cuh NQ_MAX, beside
#: K_MAX = 49, Q6's DoFs): nq = p + 2 at p = 6
NQ_MAX = 8
#: threads per block of the tile kernels (csrc/tile.cuh TNT: the residual
#: and the candidate, the post and the modal positivity); each thread of the
#: residual's lift owns 4 modes x 4 cells of one component (RB x CB)
TILE_THREADS = 256
#: (rows, columns) of cells per block of the thread-per-cell kernels (the
#: per-cell posts, check and volume residual: csrc/euler.cuh BY x BX, which
#: csrc/fused_diag.cu dflo_block_dims reports), whose diag partials number
#: these blocks
BLOCK = (4, 32)
#: the diag kernel's threads per block and the adjacent cells along x one
#: thread takes per run (csrc/fused_diag.cu DIAG_THREADS, DIAG_RUN)
DIAG_THREADS = 256
DIAG_RUN = 4
#: the diag's grid: at most this many blocks per SM (a grid-stride loop
#: covers the rest), so its workspace holds 2 x SMs x this many partials;
#: the kernel launches at most one wave of them (the blocks an SM holds at
#: once, from its registers: csrc/fused_diag.cu launch_one)
DIAG_BLOCKS_PER_SM = 4
#: the tiles of the post's and the modal positivity's kernels, largest first
#: (post_tile)
POST_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
#: the positivity points one thread of those kernels' point products takes
#: (csrc/tile.cuh PR; the points are padded to a multiple of it)
POINT_ROWS = 4
#: the dynamic shared memory one block may take on the H100 (csrc/tile.cuh
#: MAX_SMEM)
MAX_SMEM = 232448
#: the dynamic shared memory a block of those kernels may take: two blocks
#: per SM of the H100's 228 kB; the float64 post's kernel (255 registers a
#: thread, one block per SM) may take all of MAX_SMEM
POST_SMEM = 112 * 1024
#: the most cells x K (one component's staged modes) a float32 tile of the
#: modal positivity takes: beyond it the next smaller tile ran faster on
#: the H100 at P3, P4 and P6 (kernel_ab.py, PERF.md), while the post's
#: larger tiles ran faster at Q3 and Q5; float64 is bounded by POST_SMEM
MODAL_TILE_DOFS = {torch.float32: 2000, torch.float64: None}
#: the degrees whose post runs the per-cell kernel, a thread per cell on a
#: BLOCK of cells, by dtype (csrc/fused_post.cu CELL_MAX_P, a choice made
#: at build time: DFLO_POST_CELL_MAX_P_F32 and _F64)
POST_CELL_MAX_P = {torch.float32: 2, torch.float64: 1}
#: the degrees whose Pk post runs its per-cell kernel, by dtype
#: (csrc/fused_pk_post.cu PK_CELL_MAX_P, a choice made at build time:
#: DFLO_PK_POST_CELL_MAX_P_F32 and _F64): the tile kernel ran slower there
#: on the H100 (kernel_ab.py, PERF.md)
PK_POST_CELL_MAX_P = {torch.float32: 3, torch.float64: 2}
#: the most cells x K (one component's staged modes) a tile of the Pk post
#: takes, by dtype: the Pk post's tile sweep on the H100 (kernel_ab.py)
PK_TILE_DOFS = {torch.float32: 2700, torch.float64: 2000}
#: the wide tile of the MOOD check's tile kernel (csrc/fused_mood_check.cu
#: CHECK_TY x CHECK_TX): the fastest on the DMR (1152 x 288) in float32 in
#: the tile sweep on the H100 (kernel_ab.py, PERF.md)
CHECK_TILE = (16, 64)
#: whether the MOOD check runs its per-cell kernel on BLOCK, by dtype
#: (csrc/fused_mood_check.cu CHECK_PER_CELL, a choice made at build time:
#: DFLO_CHECK_PER_CELL_F32 and _F64): the tile kernel ran slower in float64
#: on the H100 (kernel_ab.py, PERF.md)
CHECK_PER_CELL = {torch.float32: False, torch.float64: True}
#: the degrees whose volume residual runs its per-cell kernel, by dtype
#: (csrc/volume_residual.cu CELL_MAX_P, a choice made at build time:
#: DFLO_VOLUME_CELL_MAX_P_F32 and _F64; at most 3): float32 Q1-Q2 and
#: float64 Q1, where it ran faster on the H100 (kernel_ab.py, PERF.md); the
#: tile kernel above
VOLUME_CELL_MAX_P = {torch.float32: 2, torch.float64: 1}
#: the cells along x of one row that a block of the volume residual's tile
#: kernel takes (csrc/volume_residual.cu TILE_X): the fastest of 32, 64
#: and 128 at Q4-Q6 in both dtypes on the H100 (kernel_ab.py, PERF.md)
VOLUME_TILE_X = 32

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_lib = None

#: the fluxes of the residual kernel and the C entry point of each (one
#: source per flux, csrc/fused_residual*.cu)
_RESIDUAL_ENTRY = {"hllc": "dflo_fused_residual",
                   "lxf": "dflo_fused_residual_lxf",
                   "roe": "dflo_fused_residual_roe",
                   "sw": "dflo_fused_residual_sw",
                   "kfvs": "dflo_fused_residual_kfvs",
                   "kep": "dflo_fused_residual_kep"}
FLUXES = tuple(_RESIDUAL_ENTRY)
#: the C entry point of the MOOD candidate per flux (one source per flux,
#: csrc/fused_mood_candidate*.cu)
_CANDIDATE_ENTRY = {f: "dflo_fused_mood_candidate"
                    + ("" if f == "hllc" else f"_{f}") for f in FLUXES}


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
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
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
        outs = [Path(tmp) / (s.stem + ".log") for s in srcs]
        t0 = time.perf_counter()
        procs = []
        for s, o, log in zip(srcs, objs, outs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
                    stdout=f, stderr=subprocess.STDOUT))
        # each source's compile time, for the build's long pole
        secs = {}
        while len(secs) < len(procs):
            for i, pr in enumerate(procs):
                if i not in secs and pr.poll() is not None:
                    secs[i] = time.perf_counter() - t0
            time.sleep(0.05)
        logs = []
        failed = []
        for i, (s, pr) in enumerate(zip(srcs, procs)):
            logs.append(f"== {s.name} ({secs[i]:.1f} s)\n"
                        + outs[i].read_text())
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
    sig = {
        "dflo_block_dims": [ci],
        "dflo_post_smem": [ci] * 6,
        "dflo_modal_pos_smem": [ci] * 5,
        **{_RESIDUAL_ENTRY[f]: [ci] * 5 + [vp] * 10 + [ci] * 4 + [vp]
           for f in FLUXES},
        "dflo_fused_residual_src": [ci] * 7 + [vp] * 12 + [cd, cd, vp]
                                   + [ci] * 4 + [vp],
        "dflo_tile_smem": [ci] * 11,
        "dflo_tile_list": [vp] + [ci] * 4 + [vp] * 3,
        "dflo_volume_residual": [ci, ci] + [vp] * 3 + [ci] * 3 + [vp],
        "dflo_volume_smem": [ci] * 2,
        **{e: [ci] * 5 + [vp] * 12 + [cd] + [ci] * 4 + [vp, vp]
           for e in _CANDIDATE_ENTRY.values()},
        "dflo_fused_post": [ci, ci] + [vp] * 10 + [ci] * 10 + [cd] * 9
                           + [ci, ci, vp],
        "dflo_fused_diag": [ci] * 3 + [vp] * 6 + [ci] * 3 + [cd, vp],
        "dflo_fused_modal_pos": [ci] * 4 + [vp] * 6
                                + [ci, ci, cd, cd, ci, ci, vp],
        "dflo_fused_pk_post": [ci] * 4 + [vp] * 6 + [ci] * 5 + [cd] * 4
                              + [ci, ci, vp],
        "dflo_pk_post_smem": [ci] * 6,
        "dflo_fused_mood_check": [ci, ci] + [vp] * 8 + [ci] * 4 + [cd, vp],
        "dflo_mood_check_smem": [ci],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    _lib = lib
    return lib


def _call(dev: torch.device, fn, *args) -> int:
    """fn(*args) (a kernel's C entry point) with dev as the current CUDA
    device: a launch goes to the current device's context, so a block on
    another card than the current one needs the switch."""
    with torch.cuda.device(dev):
        return fn(*args)


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


def _check_plane(t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...], name: str) -> None:
    """An integer or flag operand of a kernel: its own dtype, u's device."""
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {like.device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tile_count(ny: int, nx: int, tile: tuple[int, int]) -> int:
    """The ty x tx tiles (or thread blocks) over an ny x nx grid: the number
    of diag partials a kernel writes, one per tile."""
    return -(-ny // tile[0]) * -(-nx // tile[1])


def _partials(u: torch.Tensor, tile: tuple[int, int]):
    """The diag partials (lam, minq) of a launch over u's grid in tiles."""
    n = tile_count(u.shape[-2], u.shape[-1], tile)
    return (torch.empty(n, dtype=u.dtype, device=u.device),
            torch.empty(n, dtype=u.dtype, device=u.device))


def _wrappers():
    return (fused_residual, fused_mood_candidate, fused_post, fused_diag,
            fused_diag_sharded, fused_modal_pos, fused_pk_post,
            fused_mood_check, volume_residual)


#: launches per kernel form since the last reset (launch_counts)
_FORM_LAUNCHES: dict[str, int] = {}


def _count_form(key: str) -> None:
    _FORM_LAUNCHES[key] = _FORM_LAUNCHES.get(key, 0) + 1


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
    fused_pk_post.launches_with_diag = 0
    fused_post.launches_block = 0
    tile_list.launches = 0
    _FORM_LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    """Launches per wrapper since the last reset, plus the Pk post's
    launches of its diag form under "fused_pk_post_with_diag", the post's
    launches of its block form under "fused_post_block", and per form of
    the residual ("fused_residual[pk_lxf_stage]": basis, flux, a mask, and
    R, stage or step) and of the candidate ("fused_mood_candidate[lxf]")."""
    out = {fn.__name__: fn.launches for fn in _wrappers()}
    out["fused_pk_post_with_diag"] = fused_pk_post.launches_with_diag
    out["fused_post_block"] = fused_post.launches_block
    out.update(sorted(_FORM_LAUNCHES.items()))
    return out


#: the basis tags of the residual's launch-count keys
_BASIS_TAG = {"Qk": "qk", "Qk_gll": "gll", "Pk": "pk"}
#: the source arms of the residual kernel (csrc/residual.cuh SRC)
_SRC_CODE = {"grav": 1, "force": 2, "wbiso": 3}


def _residual_form(ops: "ResidualOps", u_old=None, dt=None) -> str:
    """The launch-count key of a residual call: "fused_residual[<basis>_
    <flux>[_masked][_<source>]_<form>]", basis qk, gll or pk, source grav,
    force or wbiso, form R, stage (u_old given) or step (dt given)."""
    form = "stage" if u_old is not None else "step" if dt is not None else "R"
    masked = "_masked" if ops.mask is not None else ""
    src = f"_{ops.source}" if ops.source else ""
    return (f"fused_residual[{_BASIS_TAG[ops.family]}_{ops.flux}{masked}{src}"
            f"_{form}]")


def residual_tile(K: int, dtype: torch.dtype) -> tuple[int, int]:
    """(TY, TX), the tile of cells one block of the residual's and the
    candidate's tile kernels takes for K DoFs per cell (csrc/residual.cuh):
    the largest of 8 x 16, 8 x 8, 4 x 8 and 4 x 4 whose lift gives every
    thread at most one register tile (4 components x ceil(K/4) mode blocks
    x TY*TX/4 cell blocks <= TILE_THREADS), at most 64 cells in float64
    (shared memory): 8 x 16 for up to 8 DoFs in float32, 8 x 8 for 9-16
    (Q2, Q3, P3, P4), 4 x 8 for 17-32 (Q4, P5, P6), 4 x 4 beyond."""
    mode_blocks = -(-K // 4)
    cap = 64 if dtype == torch.float64 else 128
    for ty, tx in ((8, 16), (8, 8), (4, 8), (4, 4)):
        if ty * tx <= cap and mode_blocks * ty * tx <= TILE_THREADS:
            return ty, tx
    raise NotImplementedError(f"no tile takes K = {K} DoFs per cell")


def post_smem(p: int, modal: bool, dtype: torch.dtype,
              tile: tuple[int, int], masked: bool = True,
              pos: bool = True) -> int:
    """Bytes of dynamic shared memory per block of the post (modal False,
    degree p, a masked domain and positivity by the flags) or the modal
    positivity (modal True) on a ty x tx tile: the layouts of csrc/
    fused_post.cu post_geo (the tile and its ring: DoFs, averages, the
    indicator traces; the tile's mean derivatives; with positivity the
    transposed points, the points' values and the per-cell values; the
    flag bytes; 0 for the per-cell kernel) and fused_modal_pos.cu
    modal_pos_geo (the transposed points; the tile's modes, points' values
    and per-cell values)."""
    ty, tx = tile
    size = torch.finfo(dtype).bits // 8
    qpp = -(-len(_pos_points(p)) // POINT_ROWS) * POINT_ROWS
    nc = ty * tx
    if modal:
        K = (p + 1) * (p + 2) // 2
        b = ((K + nc) * qpp + 4 * K * nc + 7 * nc) * size
    elif _post_per_cell(p, dtype):
        return 0
    else:
        K, nq, ss = (p + 1) ** 2, p + 1, (ty + 2) * (tx + 2)
        b = (4 * K * ss + 4 * ss + 4 * nq * ss + 8 * nc
             + ((K + nc) * qpp + 7 * nc if pos else 0)) * size
        b += 5 * ss if masked else 0
    return (b + 15) // 16 * 16


def pk_post_smem(p: int, dtype: torch.dtype, tile: tuple[int, int]) -> int:
    """Bytes of dynamic shared memory per block of the Pk post's tile
    kernel at degree p on a ty x tx tile, the layout of csrc/
    fused_pk_post.cu pk_post_geo (the transposed points; the tile's modes;
    the means of the tile and its ring, whose space the points' values
    take after the chain; the shock values and the per-cell values); 0 for
    the per-cell kernel."""
    if p <= PK_POST_CELL_MAX_P[dtype]:
        return 0
    ty, tx = tile
    size = torch.finfo(dtype).bits // 8
    qpp = -(-len(_pos_points(p)) // POINT_ROWS) * POINT_ROWS
    K, nc, ss = (p + 1) * (p + 2) // 2, ty * tx, (ty + 2) * (tx + 2)
    b = (K * qpp + 4 * K * nc + max(4 * ss, qpp * nc) + nc + 7 * nc) * size
    return (b + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def pk_post_tile(p: int, dtype: torch.dtype) -> tuple[int, int]:
    """(TY, TX), the tile of cells one block of the Pk post takes at degree
    p: the largest of POST_TILES whose cells x K stay within PK_TILE_DOFS
    and whose shared memory (pk_post_smem) fits POST_SMEM in float32 (two
    blocks per SM), MAX_SMEM in float64 (one block per SM by registers);
    the chain takes two threads a cell on tiles of up to TILE_THREADS / 2
    cells, one beyond.  For the per-cell forms (PK_POST_CELL_MAX_P) its
    thread block, BLOCK."""
    if p <= PK_POST_CELL_MAX_P[dtype]:
        return BLOCK
    K = (p + 1) * (p + 2) // 2
    smem = POST_SMEM if dtype == torch.float32 else MAX_SMEM
    for tile in POST_TILES:
        cells = tile[0] * tile[1]
        if (cells <= TILE_THREADS and cells * K <= PK_TILE_DOFS[dtype]
                and pk_post_smem(p, dtype, tile) <= smem):
            return tile
    raise NotImplementedError(f"no tile takes degree {p}")


def check_smem(dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory per block of the MOOD check's tile
    kernel on CHECK_TILE, the layout of csrc/fused_mood_check.cu check_geo:
    the two D2 planes with a two-cell halo, rho0, dmin, dmax, deg and lim
    with a one-cell halo (each row padded by a 16-byte vector on both
    sides) and the fail and spread flags of the tile and its ring, each
    region a multiple of 16 bytes; 0 for the per-cell kernel."""
    if CHECK_PER_CELL[dtype]:
        return 0
    ty, tx = CHECK_TILE
    size = torch.finfo(dtype).bits // 8

    def a16(b):
        return (b + 15) // 16 * 16
    pt, rows = tx + 2 * (16 // size), ty + 2
    return (a16(2 * (ty + 4) * pt * size) + 3 * a16(rows * pt * size)
            + a16(rows * (tx + 8) * 4) + a16(rows * (tx + 32))
            + 2 * a16(rows * (tx + 8)))


def check_tile(dtype: torch.dtype) -> tuple[int, int]:
    """(TY, TX), the cells one block of the MOOD check takes: CHECK_TILE,
    or BLOCK for the per-cell kernel (CHECK_PER_CELL)."""
    return BLOCK if CHECK_PER_CELL[dtype] else CHECK_TILE


def volume_smem(p: int, dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory per block of the volume residual's
    tile kernel at degree p (csrc/volume_residual.cu tile_smem): the fluxes
    [2][4][K][VOLUME_TILE_X] and the lift's coefficient table [K][2(p + 1)];
    0 where the degree runs the per-cell kernel."""
    if p <= VOLUME_CELL_MAX_P[dtype]:
        return 0
    n = p + 1
    return ((8 * n * n * VOLUME_TILE_X + 2 * n ** 3)
            * (torch.finfo(dtype).bits // 8))


@functools.lru_cache(maxsize=None)
def volume_tile(K: int, dtype: torch.dtype) -> int:
    """The cells along x of one row that a block of the volume residual's
    kernel takes for K = (p + 1)^2 nodes: VOLUME_TILE_X for the tile
    kernel, 0 for the per-cell kernel (VOLUME_CELL_MAX_P)."""
    p = round(K ** 0.5) - 1
    if (p + 1) ** 2 != K or p not in DEGREES:
        raise NotImplementedError(f"volume_residual takes the collocated "
                                  f"Q1-Q6 (K = 4, 9, ..., 49), got {K}")
    return 0 if p <= VOLUME_CELL_MAX_P[dtype] else VOLUME_TILE_X


def diag_grid(ny: int, nx: int, cap: int) -> int:
    """The diag kernel's blocks over an ny x nx grid: one thread per run of
    DIAG_RUN cells along x, at most `cap` blocks (the workspace's; a
    grid-stride loop covers the rest)."""
    runs = ny * -(-nx // DIAG_RUN)
    return max(1, min(-(-runs // DIAG_THREADS), cap))


def _post_per_cell(p: int, dtype: torch.dtype) -> bool:
    """Whether the post runs its per-cell kernel at degree p."""
    return p <= POST_CELL_MAX_P[dtype]


@functools.lru_cache(maxsize=None)
def post_tile(p: int, modal: bool, dtype: torch.dtype) -> tuple[int, int]:
    """(TY, TX), the tile of cells one block of the post (modal False) or
    the modal positivity (modal True) takes at degree p: the largest of
    POST_TILES whose shared memory (post_smem, masked and with positivity)
    fits POST_SMEM (the float64 post MAX_SMEM), whose cells get a thread
    each (the post's chain two)
    and, for the modal positivity, whose cells x K stay within
    MODAL_TILE_DOFS; for the post's per-cell forms (POST_CELL_MAX_P:
    float32 Q1-Q2, float64 Q1) its thread block, BLOCK."""
    if not modal and _post_per_cell(p, dtype):
        return BLOCK
    K = (p + 1) * (p + 2) // 2 if modal else (p + 1) ** 2
    dofs = MODAL_TILE_DOFS[dtype] if modal else None
    smem = MAX_SMEM if not modal and dtype == torch.float64 else POST_SMEM
    for tile in POST_TILES:
        cells = tile[0] * tile[1]
        # the post's chain takes two threads a cell
        if (cells * (1 if modal else 2) <= TILE_THREADS
                and (dofs is None or cells * K <= dofs)
                and post_smem(p, modal, dtype, tile) <= smem):
            return tile
    raise NotImplementedError(f"no tile takes degree {p}")


# ---------------------------------------------------------------------------
# operator buffers
# ---------------------------------------------------------------------------

def beyond_caps(basis: basis_mod.Basis) -> NotImplementedError:
    """The error of a basis beyond the kernels' bounds (a degree above 6,
    or more than NQ_MAX quadrature points per direction), raised on every
    device: no device runs it on the plain path instead."""
    return NotImplementedError(
        f"the kernels take degrees {DEGREES[0]}-{DEGREES[-1]} with at most "
        f"NQ_MAX = {NQ_MAX} quadrature points per direction; got "
        f"{basis.family} p = {basis.degree}, nq = {basis.nq} (ROADMAP, "
        f"the bounds of the general dims)")


def _check_basis(basis: basis_mod.Basis, modal: bool | None = None) -> bool:
    """True for the modal Pk basis, False for a nodal basis (Qk on its
    Gauss nodes, Qk_gll on its Gauss-Lobatto nodes, or either off its
    nodes, nq != p + 1: the same kernels, their operator values in the
    buffers); raises for a basis beyond the kernels' bounds (beyond_caps)
    and, with modal=True/False, for the other kind."""
    is_modal = basis.family == "Pk"
    if modal is not None and modal != is_modal:
        raise NotImplementedError(
            f"this kernel takes the {'modal Pk' if modal else 'nodal Qk'} "
            f"basis, got {basis.family}")
    if basis.degree not in DEGREES or basis.nq > NQ_MAX:
        raise beyond_caps(basis)
    return is_modal


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


def carries_mode0_mean(basis: basis_mod.Basis) -> bool:
    """Whether mode 0 alone carries the cell mean: a modal Pk basis whose
    other mean weights (wq2 @ V)[1:] are quadrature round-off (< 1e-13),
    on its own quadrature or an over-integrated one."""
    avg = basis.wq2 @ basis.V
    return basis.family == "Pk" and bool(np.abs(avg[1:]).max() < 1e-13)


def mode0_mean(basis: basis_mod.Basis) -> float:
    """avg0 = (wq2 @ V)[0]: modal Legendre mode 0 carries the cell mean, the
    other mean weights are quadrature round-off (< 1e-13)."""
    assert carries_mode0_mean(basis), "mode 0 must carry the mean"
    return float((basis.wq2 @ basis.V)[0])


def check_volume_lift(basis: basis_mod.Basis, lift: np.ndarray) -> None:
    """Raise unless the volume lift [K, 2K] = [dy GxW^T | dx GyW^T] of a
    collocated nodal basis lies on the tensor-product pattern that
    csrc/volume_residual.cu's tile kernel reads: node m = (i, j) takes its
    x column entries from the nodes of its own row (same j) and its y
    column entries from those of its own column (same i).  The node order
    is read off basis.nodes and must be x fastest (k = i + (p + 1) j)."""
    if not basis.is_nodal_collocated:
        raise ValueError("volume_residual takes a collocated nodal basis")
    n, K = basis.degree + 1, basis.K
    lift = np.asarray(lift)
    if lift.shape != (K, 2 * K):
        raise ValueError(f"lift shape {lift.shape} != {(K, 2 * K)}")
    # each node's x and y index: its coordinate's rank among the nodes'
    ix = np.unique(basis.nodes[:, 0], return_inverse=True)[1].ravel()
    iy = np.unique(basis.nodes[:, 1], return_inverse=True)[1].ravel()
    if not np.array_equal(ix + n * iy, np.arange(K)):
        raise ValueError("the volume kernel takes the nodes x fastest "
                         "(k = i + (p + 1) j)")
    row = iy[:, None] == iy[None, :]          # [m, k]: k in m's row
    col = ix[:, None] == ix[None, :]          # k in m's column
    off = np.concatenate([~row, ~col], axis=1) & (lift != 0)
    if off.any():
        m, k = np.argwhere(off)[0]
        raise ValueError(
            f"the volume lift is not a tensor product: entry ({m}, {k}) = "
            f"{lift[m, k]!r} lies outside node {m}'s "
            f"{'row' if k < K else 'column'}")


@dataclasses.dataclass(frozen=True)
class ResidualOps:
    """Operators of the fused residual: faceV [4, nq, K],
    lift [K, 2Q + 4nq] = [dy*GxW^T | dx*GyW^T | +W | -E | +S | -N face lifts],
    rows pre-scaled by minv/area (pallas_kernels.py:642-660), for the
    modal basis and a nodal basis off its nodes (nq != p + 1) V [Q, K],
    the basis at the Q volume quadrature points (the kernel contracts the
    DoFs to point values before the fluxes; None on a collocated basis),
    and
    avg [K], the cell-average row (LxF's dissipation speed reads the
    averages of both cells of a face; so does KEP's dissipation matrix).
    flux: one of FLUXES (kfvs in its kernel form); mask: the
    bool [ny, nx] fluid flags of a masked domain, or None.

    The source arm (pallas_kernels.py:573-593), source None or:
    "grav" (euler.GravitySource, g = (gx, gy)) and "force"
    (euler.ExternalForce: force_fn evaluated on the volume quadrature
    points xq, yq [Q, ny, nx], force_planes) with src [K, Q] =
    minv . (wq2 V)^T, the body force's projection (pallas_kernels.py:
    687-689); "wbiso", isothermal well-balanced gravity on a collocated
    basis, with the nodal derivative matrices Gxn, Gyn [K, K], inv_d =
    [1/dx, 1/dy] and the nodal potential plane phi [K, ny, nx]."""
    p: int
    K: int
    nq: int
    Q: int
    modal: bool
    family: str
    flux: str
    buf: torch.Tensor
    faceV: torch.Tensor
    lift: torch.Tensor
    V: torch.Tensor | None
    avg: torch.Tensor
    mask: torch.Tensor | None
    source: str | None = None
    g: tuple[float, float] = (0.0, 0.0)
    src: torch.Tensor | None = None
    force_fn: object = None
    xq: torch.Tensor | None = None
    yq: torch.Tensor | None = None
    Gxn: torch.Tensor | None = None
    Gyn: torch.Tensor | None = None
    inv_d: torch.Tensor | None = None
    phi: torch.Tensor | None = None


def _mask_tensor(mask, mesh, device) -> torch.Tensor | None:
    """The bool [ny, nx] fluid flags of a masked domain on device."""
    if mask is None:
        return None
    m = np.asarray(mask, bool)
    if m.shape != (mesh.ny, mesh.nx):
        raise ValueError(f"mask shape {m.shape} != {(mesh.ny, mesh.nx)}")
    return torch.as_tensor(np.ascontiguousarray(m), device=device)


#: the body-force objects the residual kernel has an arm for
_FORCE_ARMS = ((euler.GravitySource, "grav"), (euler.ExternalForce, "force"))


def carries_source(source, well_balanced: str | None) -> bool:
    """Whether the residual kernel has an arm for this source term: none,
    a euler.GravitySource or euler.ExternalForce, or isothermal
    well-balancing.  Not any other callable (a CUDA kernel cannot call it)
    nor polytropic well-balancing, which the reference keeps on its plain
    path too (pallas_kernels.py:702-704)."""
    return (well_balanced in (None, "isothermal")
            and (source is None
                 or isinstance(source, tuple(c for c, _ in _FORCE_ARMS))))


def source_kind(source, well_balanced: str | None) -> str | None:
    """The residual kernel's source arm for a make_rhs source and
    well-balanced form: None, "grav", "force" or "wbiso"; raises
    NotImplementedError where the kernel has no arm (carries_source)."""
    if well_balanced is not None and source is not None:
        raise ValueError("source and well_balanced are mutually "
                         "exclusive (the force would be applied twice)")
    if not carries_source(source, well_balanced):
        raise NotImplementedError(
            "the fused residual carries euler.GravitySource, "
            "euler.ExternalForce and well_balanced='isothermal'; any other "
            "source callable and polytropic well-balancing run on the plain "
            "path (volume_kernel='xla')")
    if well_balanced is not None:
        return "wbiso"
    return next((k for c, k in _FORCE_ARMS if isinstance(source, c)), None)


def nodal_points(basis: basis_mod.Basis, mesh) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """The physical coordinates [Q, ny, nx] of the volume quadrature points
    of every cell (the nodes of a collocated basis), x fastest."""
    QX, QY = np.meshgrid(basis.xq, basis.xq, indexing="xy")
    return mesh.point_coords(np.stack([QX.ravel(), QY.ravel()], axis=1))


def residual_operators(basis: basis_mod.Basis, mesh, *, flux: str = "lxf",
                       mask=None, source=None, well_balanced=None,
                       potential=None, dtype, device) -> ResidualOps:
    """The operators of the fused residual (ResidualOps) for the basis,
    mesh, flux, mask and source arm (source_kind); potential phi(x, y) for
    well_balanced="isothermal", evaluated with torch in dtype on device at
    the nodes."""
    modal = _check_basis(basis)
    # the DoFs go through V to the quadrature points (pallas_kernels.py:
    # 661-662): the modal basis and a nodal one off its nodes
    contract = not basis.is_nodal_collocated
    if flux not in FLUXES:
        raise ValueError(f"unknown numerical flux {flux!r}; the fused "
                         f"residual carries {FLUXES}")
    kind = source_kind(source, well_balanced)
    if kind == "wbiso":
        if contract:
            raise ValueError("well-balanced gravity needs a nodal-collocated "
                             "basis (GLL, src_gll/assemble_explicit.cc:66-72)")
        if potential is None:
            raise ValueError("well-balanced gravity needs a potential "
                             "phi(x, y)")
    scale = (1.0 / basis.mass)[:, None] / (mesh.dx * mesh.dy)
    GxW = basis.wq2[:, None] * basis.Gx
    GyW = basis.wq2[:, None] * basis.Gy
    fvw = [basis.wq[:, None] * basis.faceV[f] for f in range(4)]
    lift = np.concatenate(
        [mesh.dy * GxW.T * scale, mesh.dx * GyW.T * scale,
         mesh.dy * fvw[0].T * scale, -mesh.dy * fvw[1].T * scale,
         mesh.dx * fvw[2].T * scale, -mesh.dx * fvw[3].T * scale], axis=1)
    parts = ([basis.faceV, lift] + ([basis.V] if contract else [])
             + [basis.wq2 @ basis.V])
    if kind in ("grav", "force"):
        # minv . (wq2 V)^T, baked as the reference bakes it (the identity up
        # to rounding on a collocated basis)
        parts.append((1.0 / np.asarray(basis.mass, float))[:, None]
                     * (basis.wq2[None, :] * basis.V.T))
    elif kind == "wbiso":
        parts += [basis.Gx, basis.Gy, [1.0 / mesh.dx, 1.0 / mesh.dy]]
    buf, views = _flat(parts, dtype, device)
    n0 = 3 if contract else 2
    kw = {}
    if kind is not None:
        kw["source"] = kind
    if kind == "grav":
        kw.update(g=(float(source.gx), float(source.gy)), src=views[n0 + 1])
    elif kind == "force":
        xq, yq = nodal_points(basis, mesh)
        kw.update(src=views[n0 + 1], force_fn=source.f,
                  xq=as_tensor(xq, dtype, device),
                  yq=as_tensor(yq, dtype, device))
    elif kind == "wbiso":
        xp, yp = nodal_points(basis, mesh)
        phi = potential(as_tensor(xp, dtype, device),
                        as_tensor(yp, dtype, device))
        kw.update(Gxn=views[n0 + 1], Gyn=views[n0 + 2], inv_d=views[n0 + 3],
                  phi=torch.as_tensor(phi).to(dtype=dtype, device=device)
                  .expand(basis.K, mesh.ny, mesh.nx).contiguous())
    return ResidualOps(basis.degree, basis.K, basis.nq, len(basis.wq2), modal,
                       basis.family, flux, buf, views[0], views[1],
                       views[2] if contract else None, views[n0],
                       _mask_tensor(mask, mesh, device), **kw)


def force_planes(ops: ResidualOps, t) -> tuple[torch.Tensor, torch.Tensor]:
    """The external force's planes (fx, fy) [Q, ny, nx] at time t (a 0-dim
    tensor on the device, or a float): force_fn on the quadrature points,
    torch ops with no host sync; the kernel and its plain version read
    them alike."""
    fx, fy = ops.force_fn(ops.xq, ops.yq, t)
    return tuple(torch.as_tensor(f).to(dtype=ops.xq.dtype,
                                       device=ops.xq.device)
                 .expand(ops.xq.shape).contiguous() for f in (fx, fy))


@dataclasses.dataclass(frozen=True)
class ModalOps:
    """The {Pk truncation -> Zhang-Shu positivity} chain of the MOOD
    candidate (pallas_kernels._modal_tp_slabs): P [Qp, K], the basis at the
    positivity points; mode_degree [K] (int64), the total degree of each
    mode; avg0, the mode-0 mean weight; h, the CFL length of the diag form;
    positivity, the plain stab/positivity closure on the same operators."""
    p: int
    K: int
    avg0: float
    h: float
    P: torch.Tensor
    mode_degree: torch.Tensor
    positivity: object


def modal_operators(basis: basis_mod.Basis, mesh, *, dtype, device
                    ) -> ModalOps:
    _check_basis(basis, modal=True)
    P = as_tensor(basis.eval_at(_pos_points(basis.degree)), dtype, device)
    return ModalOps(basis.degree, basis.K, mode0_mean(basis),
                    mesh.diameter_h, P.contiguous(),
                    torch.as_tensor(basis.mode_degree, device=device),
                    make_positivity_limiter(basis, dtype=dtype,
                                            device=device))


@dataclasses.dataclass(frozen=True)
class PostOps:
    """Operators and parameters of the fused stabilization chain.

    buf holds faceV [4, nq, K], wq [nq], avg [K], gx [K], gy [K] (mean
    gradients), drx [K], dry [K] (node offsets from the cell centre) and
    P [Qp, K] (positivity points), the layout of PostOps in
    csrc/fused_post.cu (pallas_kernels.py:1167-1176 builds the same
    operators).  indicator, limit and positivity are the plain stab/*
    closures of the same chain, on the same operators.  mark_all: the
    `limiter` indicator (every cell goes to the TVB gate).  With a mask,
    vflags [5, ny, nx] (bool) holds the fluid-neighbor flags W, E, S, N
    (stab/limiter.neighbor_valid) and the cell's own fluid flag
    (pallas_kernels.py:1135-1151), and mask the fluid flags the diag
    reads; both None on an unmasked domain."""
    p: int
    K: int
    nq: int
    buf: torch.Tensor
    avg: torch.Tensor
    comp: int
    mark_all: bool
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
    vflags: torch.Tensor | None
    mask: torch.Tensor | None


def post_operators(basis: basis_mod.Basis, mesh, *, indicator: str = "density",
                   M: float = 0.0, beta: float = 1.0, char_lim: bool = False,
                   pos_lim: bool = True, per_x: bool = False,
                   per_y: bool = False, mask=None, dtype, device) -> PostOps:
    _check_basis(basis, modal=False)
    if basis.family != "Qk" or not basis.is_nodal_collocated:
        raise NotImplementedError(
            f"the fused post takes the collocated Gauss Qk basis, as the "
            f"reference's post_ok (dflo_tpu/driver.py:126-127), not "
            f"{basis.family} with nq = {basis.nq}")
    if indicator not in ("density", "energy", "limiter"):
        raise NotImplementedError(
            f"the fused post carries the limiter, density and energy "
            f"indicators, not {indicator!r}")
    h = mesh.diameter_h
    diam = float(np.sqrt(mesh.dx * mesh.dx + mesh.dy * mesh.dy))
    p = basis.degree
    buf, views = _flat(
        [basis.faceV, basis.wq, basis.wq2 @ basis.V, basis.wq2 @ basis.Gx,
         basis.wq2 @ basis.Gy, (basis.nodes[:, 0] - 0.5) * mesh.dx,
         (basis.nodes[:, 1] - 0.5) * mesh.dy,
         basis.eval_at(_pos_points(p))], dtype, device)
    ind = make_shock_indicator(basis, mesh, indicator, per_x, per_y, mask,
                               dtype=dtype, device=device)
    lim = make_tvb_limiter(basis, mesh, M=M, beta=beta, char_lim=char_lim,
                           per_x=per_x, per_y=per_y, mask=mask, dtype=dtype,
                           device=device)
    pos = (make_positivity_limiter(basis, dtype=dtype, device=device)
           if pos_lim else None)
    mask_t = _mask_tensor(mask, mesh, device)
    vflags = None
    if mask_t is not None:
        vflags = torch.stack([torch.as_tensor(v, device=device) for v in
                              neighbor_valid((mesh.ny, mesh.nx), per_x, per_y,
                                             mask)] + [mask_t]).contiguous()
    return PostOps(p, basis.K, basis.nq, buf, views[2],
                   euler.ENE if indicator == "energy" else euler.RHO,
                   indicator == "limiter", char_lim, pos_lim, per_x, per_y,
                   mesh.dx, mesh.dy, h, diam ** (0.5 * (p + 1)), M * h * h,
                   beta, ind, lim, pos, vflags, mask_t)


@dataclasses.dataclass(frozen=True)
class PkPostOps:
    """Operators and parameters of the fused Pk post (make_fused_pk_post):
    the modal TVB limiter on the cells whose shock plane exceeds 1, then
    Zhang-Shu positivity about mode 0.  P [Qp, K] feeds the kernel; limit
    and positivity are the plain stab/* closures of the same chain."""
    p: int
    K: int
    avg0: float
    h: float
    per_x: bool
    per_y: bool
    char_lim: bool
    beta: float
    Mdx2: float
    P: torch.Tensor
    limit: object
    positivity: object


def pk_post_operators(basis: basis_mod.Basis, mesh, *, M: float = 0.0,
                      beta: float = 1.0, char_lim: bool = False,
                      per_x: bool = False, per_y: bool = False, dtype,
                      device) -> PkPostOps:
    _check_basis(basis, modal=True)
    h = mesh.diameter_h
    P = as_tensor(basis.eval_at(_pos_points(basis.degree)), dtype, device)
    return PkPostOps(
        basis.degree, basis.K, mode0_mean(basis), h, per_x, per_y, char_lim,
        beta, M * h * h, P.contiguous(),
        make_tvb_limiter(basis, mesh, M=M, beta=beta, char_lim=char_lim,
                         per_x=per_x, per_y=per_y, dtype=dtype,
                         device=device),
        make_positivity_limiter(basis, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class DiagOps:
    """Operators of the fused diagnostics: the mean-weight row avg [K]
    (mode0: a modal Pk basis whose mean is avg[0] * mode 0, read alone),
    the CFL length h, the bool [ny, nx] fluid flags of a masked domain
    (solid cells enter neither reduction) or None, and on a CUDA device the
    kernel's workspace: `part`, two partials per block of its grid, and
    `ticket`, the zeroed int32 counter its last block takes (each launch
    leaves it at 0).  Calls on one workspace must be ordered (one stream):
    a Solver keeps one set, and one per block under a mesh."""
    p: int
    K: int
    avg: torch.Tensor
    h: float
    mask: torch.Tensor | None
    mode0: bool
    part: torch.Tensor | None
    ticket: torch.Tensor | None


def diag_workspace(ny: int, nx: int, dtype, device, sms: int):
    """(part, ticket) of the diag kernel on an ny x nx grid: 2 partials per
    block of diag_grid(ny, nx, sms * DIAG_BLOCKS_PER_SM) and one zeroed
    int32."""
    n = diag_grid(ny, nx, sms * DIAG_BLOCKS_PER_SM)
    return (torch.empty(2 * n, dtype=dtype, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def diag_operators(basis: basis_mod.Basis, mesh, *, mask=None, dtype,
                   device) -> DiagOps:
    _check_basis(basis)
    device = torch.device(device)
    part = ticket = None
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        part, ticket = diag_workspace(mesh.ny, mesh.nx, dtype, device, sms)
    return DiagOps(basis.degree, basis.K,
                   as_tensor(basis.wq2 @ basis.V, dtype, device),
                   mesh.diameter_h, _mask_tensor(mask, mesh, device),
                   carries_mode0_mean(basis), part, ticket)


@dataclasses.dataclass(frozen=True)
class MoodCheckOps:
    """Parameters of the fused MOOD check: the degree p (the u2 planes are
    the density modes 2 and 2p+1), avg0, and the periodic flags with the
    plain version's neighbor-exists planes (W, E, S, N)."""
    p: int
    K: int
    avg0: float
    per_x: bool
    per_y: bool
    valid: tuple


def mood_check_operators(basis: basis_mod.Basis, mesh, *, per_x: bool = False,
                         per_y: bool = False, device) -> MoodCheckOps:
    _check_basis(basis, modal=True)
    if basis.degree < 2:
        raise NotImplementedError(
            "the MOOD check kernel needs p >= 2 (the u2 smoothness test "
            "reads the D2 modes); below it stab/mood.MoodStage runs the "
            "plain check with the u2 test off, as the reference does")
    valid = tuple(torch.as_tensor(v, device=device) for v in
                  neighbor_valid((mesh.ny, mesh.nx), per_x, per_y))
    return MoodCheckOps(basis.degree, basis.K, mode0_mean(basis), per_x,
                        per_y, valid)


def _check_state(u: torch.Tensor, K: int) -> tuple[int, int]:
    if u.dim() != 4 or u.shape[0] != 4 or u.shape[1] != K:
        raise ValueError(f"state must be [4, {K}, ny, nx], got "
                         f"{tuple(u.shape)}")
    return u.shape[2], u.shape[3]


def _lam_minq(ubar, h: float, mask=None):
    """(max over cells of (c+|vx|)/h + (c+|vy|)/h, min over cells of
    min(rho, p)) from cell averages, NaN-propagating (the diag of
    pallas_kernels.py:1434-1451 and :1697-1715); 1/h rounded in the working
    dtype, as the kernels multiply by it.  Solid cells (mask False) count
    as lam = 0 and min(rho, p) = inf (pallas_kernels.py:1442-1447)."""
    rho = ubar[euler.RHO]
    pre = euler.pressure(ubar)
    cs = torch.sqrt(euler.GAMMA * torch.abs(pre) / torch.abs(rho))
    vx = torch.abs(ubar[euler.MX] / rho)
    vy = torch.abs(ubar[euler.MY] / rho)
    inv_h = recip(h, ubar)
    lam = (cs + vx) * inv_h + (cs + vy) * inv_h
    if mask is not None:
        lam = torch.where(mask, lam, torch.zeros_like(lam))
        inf = torch.full_like(rho, float("inf"))
        rho = torch.where(mask, rho, inf)
        pre = torch.where(mask, pre, inf)
    return torch.amax(lam), torch.minimum(torch.amin(rho), torch.amin(pre))


# ---------------------------------------------------------------------------
# fused residual (dense)
# ---------------------------------------------------------------------------

def _lift_ordered(lift, Fx, Fy, faces):
    """R[c, k] = sum over the lift columns of lift[k, col] * flux, as ordered
    sums in the kernel's order (csrc/residual.cuh): per volume quadrature
    point its x then its y column, then the W, E, S and N face columns."""
    Q, nq = Fx.shape[1], faces[0].shape[1]
    sh = (1, lift.shape[0]) + (1,) * (Fx.dim() - 2)

    def term(col, F):
        return lift[:, col].view(sh) * F[:, None]
    R = term(0, Fx[:, 0])
    R = R + term(Q, Fy[:, 0])
    for n in range(1, Q):
        R = R + term(n, Fx[:, n])
        R = R + term(Q + n, Fy[:, n])
    for f, F in enumerate(faces):
        for q in range(nq):
            R = R + term(2 * Q + f * nq + q, F[:, q])
    return R


def _source_plain(R, u, W, ub, ops: ResidualOps, force):
    """R plus the source arm of ops (csrc/residual.cuh SRC), in the
    kernel's order: a body force S(W) at the quadrature points added one
    point column of src at a time, R + src[:, n] S[:, n] for n in order
    (gravity from ops.g; an external force from its planes force = (fx,
    fy)); or the isothermal well-balanced source on the nodes,
    pallas_kernels.py:578-593: RT of the cell average ub, E = exp(-phi/RT),
    (Gxn E) * (1/dx) and (Gyn E) * (1/dy) as ordered sums, S = rho RT / E
    times them, R + [Sx, Sy, 0, SE]."""
    if ops.source in ("grav", "force"):
        S = (euler.forcing_gravity(W, ops.g) if ops.source == "grav"
             else euler.forcing_external(W, *force))
        sh = (1, ops.K) + (1,) * (S.dim() - 2)
        for n in range(ops.Q):
            R = R + ops.src[:, n].view(sh) * S[:, n:n + 1]
        return R
    RT = euler.pressure(ub) / ub[euler.RHO]                  # [ny, nx]
    E = torch.exp(-ops.phi / RT)                             # [K, ny, nx]
    dEx = basis_apply1(ops.Gxn, E) * ops.inv_d[0]
    dEy = basis_apply1(ops.Gyn, E) * ops.inv_d[1]
    return R + euler.well_balanced_source(u, u[euler.RHO] * RT / E, dEx, dEy)


def fused_residual_plain(u, dfw, dfe, dfs, dfn, ops: ResidualOps, u_old=None,
                         sc=None, dt=None, force=None):
    """Plain version of the fused residual: the periodic-wrap residual
    everywhere (slip-wall mirrors at fluid|solid faces of a masked domain,
    the wrap faces included), plus the delta strips lifted into the edge
    columns and rows, plus the source arm of ops (_source_plain; force: the
    external force's planes), with solid cells' residual zeroed.  With
    (u_old, sc = [a, dt]) it returns the SSP stage a*u_old + (1-a)*(u + dt*R);
    with dt alone the forward-Euler update u + dt*R (the MOOD cascade's
    first candidate); else R = M^{-1} R(u).  Every contraction is an ordered
    sum in the kernel's order."""
    num_flux = get_flux(ops.flux, kernel_safe=True)
    faceV = ops.faceV
    # collocated: nodes = quadrature points; else point values W = V u
    W = basis_apply_ordered(ops.V, u) if ops.V is not None else u
    Fx = euler.flux_x(W)
    Fy = euler.flux_y(W)
    uW, uE, uS, uN = (basis_apply_ordered(faceV[f], u) for f in range(4))
    ub = basis_reduce(ops.avg, u)[:, None]             # [4, 1, ny, nx]
    # west-face flux of every column: left state = the west neighbor's east
    # trace (periodic wrap); the east-face flux is the next column's west
    FL, FR = torch.roll(uE, 1, -1), uW
    AL, AR = torch.roll(ub, 1, -1).expand_as(FL), ub.expand_as(FR)
    if ops.mask is not None:
        FL, FR, AL, AR = euler.wall_fix(FL, FR, AL, AR,
                                        torch.roll(ops.mask, 1, -1), ops.mask,
                                        euler.mirror_x)
    Fw = num_flux(FL, FR, 1.0, 0.0, AL=AL, AR=AR)
    Fe = torch.roll(Fw, -1, -1)
    FL, FR = torch.roll(uN, 1, -2), uS
    AL, AR = torch.roll(ub, 1, -2).expand_as(FL), ub.expand_as(FR)
    if ops.mask is not None:
        FL, FR, AL, AR = euler.wall_fix(FL, FR, AL, AR,
                                        torch.roll(ops.mask, 1, -2), ops.mask,
                                        euler.mirror_y)
    Fs = num_flux(FL, FR, 0.0, 1.0, AL=AL, AR=AR)
    Fn = torch.roll(Fs, -1, -2)
    # boundary corrections at the global edge columns / rows
    Fw = torch.cat([Fw[..., :1] + dfw[..., None], Fw[..., 1:]], -1)
    Fe = torch.cat([Fe[..., :-1], Fe[..., -1:] + dfe[..., None]], -1)
    Fs = torch.cat([Fs[..., :1, :] + dfs[:, :, None], Fs[..., 1:, :]], -2)
    Fn = torch.cat([Fn[..., :-1, :], Fn[..., -1:, :] + dfn[:, :, None]], -2)
    R = _lift_ordered(ops.lift, Fx, Fy, (Fw, Fe, Fs, Fn))
    if ops.source is not None:
        R = _source_plain(R, u, W, ub[:, 0], ops, force)
    if ops.mask is not None:
        R = R * ops.mask.to(R.dtype)                   # solid cells frozen
    if u_old is not None:
        a, dt_ = sc[0], sc[1]
        return a * u_old + (1.0 - a) * (u + dt_ * R)
    if dt is not None:
        return u + dt * R
    return R


def fused_residual(u, dfw, dfe, dfs, dfn, ops: ResidualOps, u_old=None,
                   sc=None, dt=None, force=None):
    """M^{-1} R(u) with the boundary delta strips (dfw/dfe [4, nq, ny],
    dfs/dfn [4, nq, nx]); with (u_old, sc = [a, dt] on u's device) the whole
    SSP stage; with dt (a 0-dim tensor on u's device) u + dt*R.  The flux
    (FLUXES; kfvs in its kernel form), the mask and the source arm come
    with ops; an external
    force (ops.source "force") takes its planes force = (fx, fy) [Q, ny, nx]
    at the call's time (force_planes).  CPU tensors: the plain version;
    CUDA tensors: the kernel."""
    ny, nx = _check_state(u, ops.K)
    if (u_old is None) != (sc is None):
        raise ValueError("u_old and sc go together")
    if dt is not None and u_old is not None:
        raise ValueError("dt is the forward-Euler form; the stage form "
                         "takes dt in sc")
    if (force is not None) != (ops.source == "force"):
        raise ValueError("the force planes go with an external force's "
                         "operators, and only with them")
    fx, fy = (None, None) if force is None else force
    if not _cuda_or_cpu(u, dfw, dfe, dfs, dfn, u_old, sc, dt, ops.buf, fx, fy,
                        ops.phi):
        return fused_residual_plain(u, dfw, dfe, dfs, dfn, ops, u_old, sc, dt,
                                    force)
    for s, n in ((dfw, ny), (dfe, ny), (dfs, nx), (dfn, nx)):
        if tuple(s.shape) != (4, ops.nq, n):
            raise ValueError(f"strip shape {tuple(s.shape)} != "
                             f"{(4, ops.nq, n)}")
    if sc is not None and tuple(sc.shape) != (2,):
        raise ValueError("sc must be [a, dt]")
    if dt is not None and dt.numel() != 1:
        raise ValueError("dt must hold one value")
    if ops.mask is not None:
        _check_plane(ops.mask, u, torch.bool, (ny, nx), "mask")
    for plane, n in ((fx, ops.Q), (fy, ops.Q), (ops.phi, ops.K)):
        if plane is not None and tuple(plane.shape) != (n, ny, nx):
            raise ValueError(f"source plane shape {tuple(plane.shape)} != "
                             f"{(n, ny, nx)}")
    lib = _load()
    out = torch.empty_like(u)
    ptrs = (_ptr(u), _ptr(dfw), _ptr(dfe), _ptr(dfs), _ptr(dfn), _ptr(u_old),
            _ptr(sc if sc is not None else dt), _ptr(ops.buf),
            _ptr(ops.mask))
    # the basis dims: whether the DoFs go through V, the degree, K and nq
    # (csrc/residual.cuh launch_table)
    dims = (_DTYPE_CODE[u.dtype], int(ops.V is not None), ops.p, ops.K,
            ops.nq)
    tile = residual_tile(ops.K, u.dtype)
    if ops.source is None:
        entry = getattr(lib, _RESIDUAL_ENTRY[ops.flux])
        rc = _call(u.device, entry, *dims, *ptrs, _ptr(out), ny, nx, *tile,
                   _stream(u.device))
    else:
        rc = _call(u.device, lib.dflo_fused_residual_src, *dims,
                   FLUXES.index(ops.flux), _SRC_CODE[ops.source], *ptrs,
                   _ptr(fx), _ptr(fy), _ptr(ops.phi), *ops.g, _ptr(out), ny,
                   nx, *tile, _stream(u.device))
    _check(rc, "fused_residual")
    fused_residual.launches += 1
    _count_form(_residual_form(ops, u_old, dt))
    return out


fused_residual.launches = 0


# ---------------------------------------------------------------------------
# fused modal positivity and the sparse MOOD candidate
# ---------------------------------------------------------------------------

def modal_tp_plain(u, deg, ops: ModalOps):
    """{Pk truncation to deg -> Zhang-Shu positivity about mode 0} on
    u[4, K, *cells] with deg[*cells] (None: positivity only); the plain
    twin of the tile kernels' truncation and positivity phases (csrc/
    tile.cuh tile_truncate, tile_thetas, zs_scale; pallas_kernels.
    _modal_tp_slabs)."""
    if deg is not None:
        md = ops.mode_degree.view((1, ops.K) + (1,) * (u.dim() - 2))
        u = torch.where(md <= deg[None, None], u,
                        torch.zeros((), dtype=u.dtype, device=u.device))
    return ops.positivity(u, ops.avg0 * u[:, 0])


def tile_flags(cells: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """uint8 [ceil(ny/ty), ceil(nx/tx)]: 1 for each ty x tx tile that holds
    a set cell of the bool plane `cells`.  Plane ops on the device: no host
    sync, no nonzero()."""
    ny, nx = cells.shape
    nty, ntx = -(-ny // ty), -(-nx // tx)
    c = F.pad(cells.to(torch.uint8), (0, ntx * tx - nx, 0, nty * ty - ny))
    return c.view(nty, ty, ntx, tx).amax(dim=(1, 3)).contiguous()


def tile_list_plain(cells: torch.Tensor, ty: int, tx: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The compact list of the ty x tx tiles that hold a set cell of the
    bool plane `cells`: (int32 [ntiles], the flagged tiles' row-major
    indices in increasing order first, the rest unspecified; int32 [1],
    their count).  Plane ops (a prefix sum and a scatter): no host sync, no
    nonzero().  The plain twin of the candidate's list kernel (csrc/
    candidate.cuh tile_list_kernel), which fills the same slots in no fixed
    order."""
    flags = tile_flags(cells, ty, tx).view(-1)
    n = flags.numel()
    pos = torch.cumsum(flags, 0, dtype=torch.int32)
    count = pos[-1:].clone() if n else pos.new_zeros(1)
    # flagged tile i goes to slot pos[i] - 1, the others to a spare slot n
    slot = torch.where(flags.bool(), pos - 1, n).long()
    lst = torch.zeros(n + 1, dtype=torch.int32, device=cells.device)
    lst.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                       device=cells.device))
    return lst[:n], count


def tile_list(cells: torch.Tensor, ty: int, tx: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """tile_list_plain for a CPU plane; for a CUDA plane the candidate's
    list kernel (one launch after zeroing the count; the flagged tiles in
    no fixed order).  The candidate's entry points build their list with
    the same kernel themselves."""
    if cells.device.type == "cpu":
        return tile_list_plain(cells, ty, tx)
    if cells.device.type != "cuda":
        raise ValueError(f"tensors on {cells.device} are not supported")
    _check_plane(cells, cells, torch.bool, tuple(cells.shape), "cells")
    ny, nx = cells.shape
    lst = torch.empty(-(-ny // ty) * -(-nx // tx), dtype=torch.int32,
                      device=cells.device)
    count = torch.empty(1, dtype=torch.int32, device=cells.device)
    _check(_call(cells.device, _load().dflo_tile_list, _ptr(cells), ny, nx,
                 ty, tx, _ptr(lst), _ptr(count), _stream(cells.device)),
           "tile_list")
    tile_list.launches += 1
    return lst, count


tile_list.launches = 0


def fused_mood_candidate_plain(u_pre, u_prev, deg, cells, dfw, dfe, dfs,
                               dfn, rops: ResidualOps, mops: ModalOps, dt):
    """Plain version of the sparse MOOD candidate: u_t + dt*R(u_t) with
    u_t = modal_tp(u_pre, deg), written into u_prev on the cells set in
    `cells`; every other cell keeps u_prev.  The strips must come from the
    same u_t (solver/spatial strips(u_pre, t, deg))."""
    cand = fused_residual_plain(modal_tp_plain(u_pre, deg, mops), dfw, dfe,
                                dfs, dfn, rops, dt=dt)
    return u_prev.copy_(torch.where(cells[None, None], cand, u_prev))


def fused_mood_candidate(u_pre, u_prev, deg, cells, dfw, dfe, dfs, dfn,
                         rops: ResidualOps, mops: ModalOps, dt):
    """The one-pass MOOD candidate u_t + dt*R(u_t), u_t = {truncation to
    deg -> positivity}(u_pre) applied to each cell and to each face
    neighbor with its own degree, recomputed on the cells set in the bool
    plane `cells` and written IN PLACE into u_prev; the other cells keep
    u_prev.  Returns u_prev.  With every cell set it is the dense
    candidate.  CPU tensors: the plain version; CUDA tensors: the kernel,
    over the compact list of the residual_tile tiles that hold a set cell,
    which its entry point builds on the device first (tile_list): no block
    works on a tile without one."""
    ny, nx = _check_state(u_pre, rops.K)
    if not rops.modal:
        raise NotImplementedError("the MOOD candidate takes the modal Pk "
                                  "basis")
    if rops.mask is not None or rops.source is not None:
        raise ValueError("the MOOD candidate takes no mask and no source "
                         "arm, as the reference's sparse pass "
                         "(dflo_tpu/stab/mood.py:272-274, dflo_tpu/solver/"
                         "spatial.py:498-499); such a cascade takes the "
                         "dense route (stab/mood.MoodStage)")
    if tuple(u_prev.shape) != tuple(u_pre.shape):
        raise ValueError("u_prev must have u_pre's shape")
    if not _cuda_or_cpu(u_pre, u_prev, dfw, dfe, dfs, dfn, dt, rops.buf,
                        mops.P):
        return fused_mood_candidate_plain(u_pre, u_prev, deg, cells, dfw, dfe,
                                          dfs, dfn, rops, mops, dt)
    _check_plane(deg, u_pre, torch.int32, (ny, nx), "deg")
    _check_plane(cells, u_pre, torch.bool, (ny, nx), "cells")
    for s, n in ((dfw, ny), (dfe, ny), (dfs, nx), (dfn, nx)):
        if tuple(s.shape) != (4, rops.nq, n):
            raise ValueError(f"strip shape {tuple(s.shape)} != "
                             f"{(4, rops.nq, n)}")
    if tuple(mops.P.shape[1:]) != (rops.K,):
        raise ValueError("the modal operators' K differs from the "
                         "residual's")
    tile = residual_tile(rops.K, u_pre.dtype)
    # the tile list's scratch: the entry point builds the list there first
    tiles = torch.empty(-(-ny // tile[0]) * -(-nx // tile[1]),
                        dtype=torch.int32, device=u_pre.device)
    count = torch.empty(1, dtype=torch.int32, device=u_pre.device)
    lib = _load()
    entry = getattr(lib, _CANDIDATE_ENTRY[rops.flux])
    # the basis dims: degree, modes, quadrature points per direction and
    # positivity points (csrc/candidate.cuh candidate_entry: P1-P3 on
    # nq = p + 1 their own instantiations, every other basis the general
    # candidate)
    rc = _call(u_pre.device, entry, _DTYPE_CODE[u_pre.dtype], rops.p,
        rops.K, rops.nq, mops.P.shape[0], _ptr(u_pre), _ptr(deg),
        _ptr(cells), _ptr(tiles), _ptr(count), _ptr(dfw), _ptr(dfe),
        _ptr(dfs), _ptr(dfn), _ptr(dt), _ptr(rops.buf), _ptr(mops.P),
        mops.avg0, ny, nx, *tile, _ptr(u_prev), _stream(u_pre.device))
    _check(rc, "fused_mood_candidate")
    fused_mood_candidate.launches += 1
    _count_form(f"fused_mood_candidate[{rops.flux}]")
    return u_prev


fused_mood_candidate.launches = 0


def fused_modal_pos_plain(u, ops: ModalOps, deg=None, with_diag=False):
    """Plain version of the fused modal positivity: modal_tp_plain, plus
    (lam_max, minq) of the mode-0 means with with_diag (truncation keeps
    mode 0 and Zhang-Shu scales about the mean)."""
    out = modal_tp_plain(u, deg, ops)
    if not with_diag:
        return out
    return (out, *_lam_minq(ops.avg0 * u[:, 0], ops.h))


def fused_modal_pos(u, ops: ModalOps, deg=None, with_diag: bool = False):
    """{truncation to deg ->} Zhang-Shu positivity about mode 0 on a Pk
    state (deg None: no truncation); with_diag also returns the 0-dim
    (lam_max, minq).  CPU tensors: the plain version; CUDA tensors: the
    tile kernel (post_tile; its per-tile diag partials reduced here)."""
    ny, nx = _check_state(u, ops.K)
    if not _cuda_or_cpu(u, ops.P):
        return fused_modal_pos_plain(u, ops, deg, with_diag)
    if deg is not None:
        _check_plane(deg, u, torch.int32, (ny, nx), "deg")
    lib = _load()
    out = torch.empty_like(u)
    tile = post_tile(ops.p, True, u.dtype)
    lam_p = minq_p = None
    if with_diag:
        lam_p, minq_p = _partials(u, tile)
    rc = _call(u.device, lib.dflo_fused_modal_pos,
        _DTYPE_CODE[u.dtype], ops.p, ops.K, ops.P.shape[0], _ptr(u),
        _ptr(deg), _ptr(ops.P), _ptr(out), _ptr(lam_p), _ptr(minq_p), ny, nx,
        ops.avg0, ops.h, *tile, _stream(u.device))
    _check(rc, "fused_modal_pos")
    fused_modal_pos.launches += 1
    if not with_diag:
        return out
    return out, torch.amax(lam_p), torch.amin(minq_p)


fused_modal_pos.launches = 0


# ---------------------------------------------------------------------------
# fused post (nodal Qk)
# ---------------------------------------------------------------------------

def _pad_halos(u, halos):
    """u[4, K, ly, lx] framed by its halo lines -> [4, K, ly+2, lx+2]; a
    missing line (None) takes the block's own opposite edge, the wrap the
    kernel reads there; the corners (read by no cell) repeat the S and N
    lines' end cells."""
    hW, hE, hS, hN = (h if h is not None else w for h, w in zip(
        halos, (u[..., -1], u[..., 0], u[..., -1, :], u[..., 0, :])))
    mid = torch.cat([hW[..., None], u, hE[..., None]], dim=-1)

    def row(h):
        return torch.cat([h[..., :1], h, h[..., -1:]], dim=-1)[..., None, :]
    return torch.cat([row(hS), mid, row(hN)], dim=-2)


def _padded_valid(ly: int, lx: int, halos, device):
    """The neighbor-exists flags (W, E, S, N) of the framed block: every
    cell has its neighbors, except that a border cell of a side whose halo
    is None (a true, non-periodic domain edge) has none across it."""
    valid = [torch.ones((ly + 2, lx + 2), dtype=torch.bool, device=device)
             for _ in range(4)]
    if halos[0] is None:
        valid[0][:, 1] = False
    if halos[1] is None:
        valid[1][:, lx] = False
    if halos[2] is None:
        valid[2][1, :] = False
    if halos[3] is None:
        valid[3][ly, :] = False
    return tuple(valid)


def fused_post_plain(u, ops: PostOps, with_diag: bool = False, halos=None):
    """Plain version of the fused post: the stab/* chain
    {cell averages -> KXRCF -> TVB -> positivity}, plus (lam_max, minq) of
    the cell averages with with_diag (the chain preserves cell means).
    halos = (hW, hE, hS, hN) (parallel/sharding.exchange_halos): the block
    form, the same chain on the block framed by its halo lines, with the
    border flags of its true domain edges."""
    valid = None
    if halos is not None:
        if ops.vflags is not None:
            raise NotImplementedError(
                "the post on a masked domain under a device mesh is not "
                "ported yet; it comes with slice G, the rest of multi-GPU "
                "(ROADMAP)")
        ly, lx = u.shape[-2:]
        valid = _padded_valid(ly, lx, halos, u.device)
        u = _pad_halos(u, halos)
    ubar = basis_reduce(ops.avg, u)
    shock, _ = ops.indicator(u, ubar, valid=valid)
    u1 = ops.limit(u, ubar, shock, valid=valid)
    if ops.positivity is not None:
        u1 = ops.positivity(u1, ubar)
    if halos is not None:
        u1 = u1[..., 1:-1, 1:-1].contiguous()
        ubar = ubar[..., 1:-1, 1:-1]
    if not with_diag:
        return u1
    return (u1, *_lam_minq(ubar, ops.h, ops.mask))


def fused_post(u, ops: PostOps, with_diag: bool = False, halos=None):
    """One stage's stabilization chain (a masked domain's solid cells count
    as missing neighbors and enter neither diag reduction); with_diag also
    returns the 0-dim tensors (lam_max, minq).  halos = (hW, hE, hS, hN):
    the block form, on one block of a domain split over a device mesh (its
    neighbors' edge DoF lines; None on a true, non-periodic domain edge,
    whose border cells then have no neighbor across it).  CPU tensors: the
    plain version; CUDA tensors: the kernel on the tile of post_tile (the
    tile kernel, or the per-cell kernel on its BLOCK; the diag partials,
    one per tile, reduced here with amax/amin)."""
    ny, nx = _check_state(u, ops.K)
    hs = (None,) * 4 if halos is None else tuple(halos)
    if not _cuda_or_cpu(u, ops.buf, *hs):
        return fused_post_plain(u, ops, with_diag, halos)
    if ops.vflags is not None:
        if halos is not None:
            raise NotImplementedError(
                "the post on a masked domain under a device mesh is not "
                "ported yet; it comes with slice G, the rest of multi-GPU "
                "(ROADMAP)")
        _check_plane(ops.vflags, u, torch.bool, (5, ny, nx), "vflags")
    for h, n in zip(hs, (ny, ny, nx, nx)):
        if h is not None and tuple(h.shape) != (4, ops.K, n):
            raise ValueError(f"halo line shape {tuple(h.shape)} != "
                             f"{(4, ops.K, n)}")
    if halos is None:
        nb = (ops.per_x, ops.per_x, ops.per_y, ops.per_y)
    else:
        nb = tuple(h is not None for h in hs)
    lib = _load()
    out = torch.empty_like(u)
    tile = post_tile(ops.p, False, u.dtype)
    lam_p = minq_p = None
    if with_diag:
        lam_p, minq_p = _partials(u, tile)
    rc = _call(u.device, lib.dflo_fused_post,
        _DTYPE_CODE[u.dtype], ops.p, _ptr(u), _ptr(ops.buf),
        _ptr(ops.vflags), *map(_ptr, hs), _ptr(out), _ptr(lam_p),
        _ptr(minq_p), ny, nx, *map(int, nb), ops.comp, int(ops.mark_all),
        int(ops.char_lim), int(ops.pos_lim), ops.dx, ops.dy, ops.h,
        ops.h / ops.dx, ops.h / ops.dy, 1.0 / ops.h, ops.diam_pow, ops.Mdx2,
        ops.beta, *tile, _stream(u.device))
    _check(rc, "fused_post")
    fused_post.launches += 1
    if halos is not None:
        fused_post.launches_block += 1
    if not with_diag:
        return out
    return out, torch.amax(lam_p), torch.amin(minq_p)


fused_post.launches = 0
fused_post.launches_block = 0


def _sharded(post, blocks, ops, dm: DeviceMesh, with_diag: bool):
    """post (fused_post or its plain version) on every block with its halo
    lines; with with_diag the per-block (lam, minq) reduced across the
    blocks."""
    if len(blocks) != len(ops) or len(blocks) != len(dm.flat):
        raise ValueError("one block and one operator set per mesh device")
    halos = exchange_halos(blocks, dm, ops[0].per_x, ops[0].per_y)
    outs = [post(u, o, with_diag, halos=h)
            for u, o, h in zip(blocks, ops, halos)]
    if not with_diag:
        return outs
    return ([o[0] for o in outs], reduce_max([o[1] for o in outs]),
            reduce_min([o[2] for o in outs]))


def fused_post_sharded_plain(blocks, ops, dm: DeviceMesh,
                             with_diag: bool = False):
    """Plain version of fused_post_sharded: fused_post_plain's block form on
    every block."""
    return _sharded(fused_post_plain, blocks, ops, dm, with_diag)


def fused_post_sharded(blocks, ops, dm: DeviceMesh, with_diag: bool = False):
    """The post of a state split over a device mesh (make_fused_post_sharded,
    pallas_kernels.py:1536-1652): blocks, the row-major block list; ops, one
    PostOps per block (on its device).  Exchanges the halo lines, runs the
    post's block form on each block (CUDA blocks: the kernel, once per
    block) and, with with_diag, reduces the blocks' (lam_max, minq) on the
    first block's device.  Equal to the single-device post on the gathered
    state, bitwise."""
    return _sharded(fused_post, blocks, ops, dm, with_diag)


# ---------------------------------------------------------------------------
# fused Pk post (the MOOD stage's stabilization)
# ---------------------------------------------------------------------------

def fused_pk_post_plain(u, shock, ops: PkPostOps, with_diag: bool = False):
    """Plain version of the fused Pk post: mode-0 averages -> modal TVB on
    the cells with shock > 1 -> Zhang-Shu positivity (the XLA chain of
    dflo_tpu/driver.py _mood_rk_step), plus (lam_max, minq) of the means
    with with_diag (the chain preserves them)."""
    ubar = ops.avg0 * u[:, 0]
    u1 = ops.positivity(ops.limit(u, ubar, shock), ubar)
    if not with_diag:
        return u1
    return (u1, *_lam_minq(ubar, ops.h))


def fused_pk_post(u, shock, ops: PkPostOps, with_diag: bool = False):
    """The MOOD stage's post on a Pk state: shock [ny, nx] in u's dtype
    (2.0 where the cascade marked the cell, else 0); with_diag also returns
    the 0-dim (lam_max, minq).  CPU tensors: the plain version; CUDA
    tensors: the kernel (pk_post_tile; its per-tile diag partials reduced
    here)."""
    ny, nx = _check_state(u, ops.K)
    if not _cuda_or_cpu(u, shock, ops.P):
        return fused_pk_post_plain(u, shock, ops, with_diag)
    if tuple(shock.shape) != (ny, nx):
        raise ValueError(f"shock shape {tuple(shock.shape)} != {(ny, nx)}")
    lib = _load()
    out = torch.empty_like(u)
    tile = pk_post_tile(ops.p, u.dtype)
    lam_p = minq_p = None
    if with_diag:
        lam_p, minq_p = _partials(u, tile)
    rc = _call(u.device, lib.dflo_fused_pk_post,
        _DTYPE_CODE[u.dtype], ops.p, ops.K, ops.P.shape[0], _ptr(u),
        _ptr(shock), _ptr(ops.P), _ptr(out), _ptr(lam_p), _ptr(minq_p), ny,
        nx, int(ops.per_x), int(ops.per_y), int(ops.char_lim), ops.avg0,
        0.5 * ops.beta, ops.Mdx2, ops.h, *tile, _stream(u.device))
    _check(rc, "fused_pk_post")
    fused_pk_post.launches += 1
    if not with_diag:
        return out
    fused_pk_post.launches_with_diag += 1
    return out, torch.amax(lam_p), torch.amin(minq_p)


fused_pk_post.launches = 0
fused_pk_post.launches_with_diag = 0


# ---------------------------------------------------------------------------
# fused diag
# ---------------------------------------------------------------------------

def diag_means(u, ops: DiagOps):
    """The cell averages [4, ny, nx] the diag reads: avg[0] * mode 0 on a
    modal Pk basis (ops.mode0), else the ordered sum over the row."""
    if ops.mode0:
        return ops.avg[0] * u[:, 0]
    return basis_reduce(ops.avg, u)


def fused_diag_plain(u, ops: DiagOps):
    """Plain version of the fused diag: compute_dt's wave speed and the
    negativity min over the (fluid) cell averages of u."""
    return _lam_minq(diag_means(u, ops), ops.h, ops.mask)


def _diag_launch(u, ops: DiagOps):
    """The diag kernel on CUDA tensors (True) or its plain version (False),
    as the pair ((lam_max, minq), launched)."""
    ny, nx = _check_state(u, ops.K)
    if not _cuda_or_cpu(u, ops.avg, ops.part):
        return fused_diag_plain(u, ops), False
    if ops.part is None:
        raise ValueError("these DiagOps hold no workspace: build them on "
                         "the state's CUDA device")
    _check_plane(ops.ticket, u, torch.int32, (1,), "ticket")
    if ops.mask is not None:
        _check_plane(ops.mask, u, torch.bool, (ny, nx), "mask")
    lib = _load()
    out = torch.empty(2, dtype=u.dtype, device=u.device)
    blocks = diag_grid(ny, nx, ops.part.numel() // 2)
    rc = _call(u.device, lib.dflo_fused_diag, _DTYPE_CODE[u.dtype], ops.K,
               int(ops.mode0), _ptr(u), _ptr(ops.avg), _ptr(ops.mask),
               _ptr(ops.part), _ptr(ops.ticket), _ptr(out), ny, nx, blocks,
               ops.h, _stream(u.device))
    _check(rc, "fused_diag")
    return (out[0], out[1]), True


def fused_diag(u, ops: DiagOps):
    """(lam_max, minq) as 0-dim tensors, over the fluid cells of a masked
    domain.  CPU tensors: the plain version; CUDA tensors: one launch of
    the kernel, which reduces across its blocks itself (bitwise equal to
    the plain version)."""
    out, launched = _diag_launch(u, ops)
    fused_diag.launches += launched
    return out


fused_diag.launches = 0


def fused_diag_sharded_plain(blocks, ops, dm: DeviceMesh):
    """Plain version of fused_diag_sharded: the plain diag of every block,
    reduced across the blocks."""
    if len(blocks) != len(ops) or len(blocks) != len(dm.flat):
        raise ValueError("one block and one operator set per mesh device")
    pairs = [fused_diag_plain(u, o) for u, o in zip(blocks, ops)]
    return (reduce_max([p[0] for p in pairs]),
            reduce_min([p[1] for p in pairs]))


def fused_diag_sharded(blocks, ops, dm: DeviceMesh):
    """(lam_max, minq) of a state split over a device mesh
    (make_fused_diag_sharded, pallas_kernels.py:1758-1792): the diag of
    every block (CUDA blocks: csrc/fused_diag.cu, once per block), then
    max / min across the blocks on the first block's device.  ops: one
    DiagOps per block (on its device).  Equal to the single-device diag."""
    if len(blocks) != len(ops) or len(blocks) != len(dm.flat):
        raise ValueError("one block and one operator set per mesh device")
    pairs = []
    for u, o in zip(blocks, ops):
        out, launched = _diag_launch(u, o)
        fused_diag_sharded.launches += launched
        pairs.append(out)
    return (reduce_max([p[0] for p in pairs]),
            reduce_min([p[1] for p in pairs]))


fused_diag_sharded.launches = 0


# ---------------------------------------------------------------------------
# fused MOOD check
# ---------------------------------------------------------------------------

def fused_mood_check_plain(u_c, dmp_min, dmp_max, deg, lim,
                           ops: MoodCheckOps):
    """Plain version of the fused MOOD check: stab/mood.check_update on the
    candidate's density planes (mode 0, D2xx = mode 2, D2yy = mode 2p+1)."""
    return mood_mod.check_update(
        ops.avg0 * u_c[euler.RHO, 0], u_c[euler.RHO, 2],
        u_c[euler.RHO, 2 * ops.p + 1], dmp_min, dmp_max, deg, lim, ops.valid)


def fused_mood_check(u_c, dmp_min, dmp_max, deg, lim, ops: MoodCheckOps):
    """One acceptance pass of the MOOD cascade on the candidate u_c:
    DMP against [dmp_min, dmp_max], u2 smoothness, degree reduction, limiter
    marks and their spread to face neighbors.  deg int32 and lim bool
    [ny, nx]; returns (deg_new int32, lim_new bool, chg bool).  CPU tensors:
    the plain version; CUDA tensors: the kernel on check_tile's blocks
    (bitwise equal to it), lim_new and chg two planes of one allocation."""
    ny, nx = _check_state(u_c, ops.K)
    if not _cuda_or_cpu(u_c, dmp_min, dmp_max):
        return fused_mood_check_plain(u_c, dmp_min, dmp_max, deg, lim, ops)
    for t, name in ((dmp_min, "dmp_min"), (dmp_max, "dmp_max")):
        if tuple(t.shape) != (ny, nx):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(ny, nx)}")
    _check_plane(deg, u_c, torch.int32, (ny, nx), "deg")
    _check_plane(lim, u_c, torch.bool, (ny, nx), "lim")
    lib = _load()
    deg_new = torch.empty_like(deg)
    lim_new, chg = torch.empty((2, ny, nx), dtype=torch.bool,
                               device=lim.device)
    rc = _call(u_c.device, lib.dflo_fused_mood_check,
        _DTYPE_CODE[u_c.dtype], ops.p, _ptr(u_c), _ptr(dmp_min),
        _ptr(dmp_max), _ptr(deg), _ptr(lim), _ptr(deg_new), _ptr(lim_new),
        _ptr(chg), ny, nx, int(ops.per_x), int(ops.per_y), ops.avg0,
        _stream(u_c.device))
    _check(rc, "fused_mood_check")
    fused_mood_check.launches += 1
    return deg_new, lim_new, chg


fused_mood_check.launches = 0


# ---------------------------------------------------------------------------
# volume residual (collocated Qk)
# ---------------------------------------------------------------------------

def volume_residual_plain(lift, u):
    """Plain version of volume_residual: the Euler fluxes at the K
    collocated nodes, then R[c, m] = sum_k lift[m, k] Fx[c, k]
    + lift[m, K + k] Fy[c, k] as one ordered sum (per node its x then its y
    column), the kernel's order."""
    K = u.shape[1]
    Fx = euler.flux_x(u)
    Fy = euler.flux_y(u)
    sh = (1, K) + (1,) * (u.dim() - 2)

    def term(col, F):
        return lift[:, col].view(sh) * F[:, None]
    R = term(0, Fx[:, 0])
    R = R + term(K, Fy[:, 0])
    for k in range(1, K):
        R = R + term(k, Fx[:, k])
        R = R + term(K + k, Fy[:, k])
    return R


def volume_residual(lift, u):
    """The collocated volume term [dy GxW^T | dx GyW^T] @ [Fx; Fy] of
    u[4, K, ny, nx] (the `volume_kernel='pallas'` path of solver/spatial,
    pallas_kernels.volume_residual): lift [K, 2K] in u's dtype, on the
    tensor-product pattern (check_volume_lift, which make_rhs runs once).
    CPU tensors: the plain version; CUDA tensors: the kernel (the per-cell
    one up to VOLUME_CELL_MAX_P, the tile kernel above)."""
    if u.dim() != 4 or u.shape[0] != 4:
        raise ValueError(f"state must be [4, K, ny, nx], got "
                         f"{tuple(u.shape)}")
    K, (ny, nx) = u.shape[1], u.shape[2:]
    if tuple(lift.shape) != (K, 2 * K):
        raise ValueError(f"lift shape {tuple(lift.shape)} != {(K, 2 * K)}")
    if not _cuda_or_cpu(u, lift):
        return volume_residual_plain(lift, u)
    tx = volume_tile(K, u.dtype)
    lib = _load()
    out = torch.empty_like(u)
    rc = _call(u.device, lib.dflo_volume_residual, _DTYPE_CODE[u.dtype], K,
               _ptr(u), _ptr(lift), _ptr(out), ny, nx, tx, _stream(u.device))
    _check(rc, "volume_residual")
    volume_residual.launches += 1
    return out


volume_residual.launches = 0
