"""ctypes bindings for the port's native host library (dflo_native.cc beside
this file): the Gmsh 2.x reader ``msh_parse`` and the appended-binary VTU
writer ``vtu_write``, after dflo_tpu/native.py:21-116.

The library is built at first use with ``g++ -O3 -fPIC -std=c++17 -shared``
into ``dflo_tpu_torch/_build/``, keyed by a hash of the source and flags,
as the CUDA kernels are (ops/kernels.build); nothing is written beside the
source.  Unlike the reference, which falls back to Python when its build
fails, a failed build raises RuntimeError with the compiler's message: the
pure-Python parser (mesh/msh.parse_msh) and writer (io/vtk._write_vtu_file)
are the plain versions, taken only when a caller asks for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dflo_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None


class _MshData(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("node_ids", ctypes.POINTER(ctypes.c_int64)),
        ("xy", ctypes.POINTER(ctypes.c_double)),
        ("n_quads", ctypes.c_int64),
        ("quads", ctypes.POINTER(ctypes.c_int64)),
        ("n_lines", ctypes.c_int64),
        ("lines", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char * 256),
    ]


def build() -> Path:
    """Compile dflo_native.cc (if not built yet) and return the library's
    path; raises RuntimeError if the compiler fails or is missing."""
    h = hashlib.sha256(repr(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libdflo_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native mesh reader and VTU "
                           "writer (dflo_tpu_torch/native) are built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        try:
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out),
                                  str(SOURCE)], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the compiler {cxx!r}: {e}") \
                from e
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(out, so)
    return so


def get_lib():
    """The loaded library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        dp, dpp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(
            ctypes.POINTER(ctypes.c_double))
        lib.msh_parse.restype = ctypes.POINTER(_MshData)
        lib.msh_parse.argtypes = [ctypes.c_char_p]
        lib.msh_free.restype = None
        lib.msh_free.argtypes = [ctypes.POINTER(_MshData)]
        lib.vtu_write.restype = ctypes.c_int
        lib.vtu_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, dp, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_char_p,
            dpp, ctypes.c_int, ctypes.c_char_p, dpp, ctypes.c_double]
        _lib = lib
    return _lib


def msh_parse(path: str):
    """Parse a Gmsh 2.x ASCII mesh: (nodes{id: (x, y)}, quads[(n1..n4,
    phys)], lines[(n1, n2, phys)]), the structures of mesh/msh.parse_msh."""
    lib = get_lib()
    d = lib.msh_parse(os.fsencode(path))
    if not d:
        raise MemoryError("msh_parse allocation failed")
    try:
        err = d.contents.error
        if err and err[0:1] != b"\x00":
            raise ValueError(f"native msh_parse: {err.decode()}")
        n = d.contents.n_nodes
        ids = np.ctypeslib.as_array(d.contents.node_ids, shape=(n,)).copy() \
            if n else np.zeros(0, np.int64)
        xy = np.ctypeslib.as_array(d.contents.xy, shape=(n, 2)).copy() \
            if n else np.zeros((0, 2))
        nq = d.contents.n_quads
        quads = np.ctypeslib.as_array(d.contents.quads, shape=(nq, 5)).copy() \
            if nq else np.zeros((0, 5), np.int64)
        nl = d.contents.n_lines
        lines = np.ctypeslib.as_array(d.contents.lines, shape=(nl, 3)).copy() \
            if nl else np.zeros((0, 3), np.int64)
    finally:
        lib.msh_free(d)
    nodes = dict(zip(ids.tolist(), map(tuple, xy.tolist())))
    return (nodes, list(map(tuple, quads.tolist())),
            list(map(tuple, lines.tolist())))


def vtu_write(path: str, points, conn, point_fields: dict,
              cell_fields: dict, time: float = 0.0) -> None:
    """Write a VTU snapshot with the native appended-binary writer: points
    [n, 3], conn [cells, 4], fields name -> [n] (point) or [cells] (cell)
    arrays.  Raises OSError if the file cannot be written."""
    lib = get_lib()
    points = np.ascontiguousarray(points, np.float64)
    conn = np.ascontiguousarray(conn, np.int32)
    npts, ncells = len(points), len(conn)
    pf = [np.ascontiguousarray(v, np.float64) for v in point_fields.values()]
    cf = [np.ascontiguousarray(v, np.float64) for v in cell_fields.values()]
    if points.shape != (npts, 3) or conn.shape != (ncells, 4):
        raise ValueError(f"points {points.shape} / conn {conn.shape}: need "
                         f"[n, 3] and [cells, 4]")
    if any(a.shape != (npts,) for a in pf) or any(a.shape != (ncells,)
                                                  for a in cf):
        raise ValueError("each point field needs one value a point and "
                         "each cell field one a cell")
    dp = ctypes.POINTER(ctypes.c_double)
    PF = (dp * max(len(pf), 1))(*[p.ctypes.data_as(dp) for p in pf])
    CF = (dp * max(len(cf), 1))(*[c.ctypes.data_as(dp) for c in cf])
    rc = lib.vtu_write(
        os.fsencode(path), npts, points.ctypes.data_as(dp), ncells,
        conn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(pf),
        "\n".join(point_fields).encode(), PF, len(cf),
        "\n".join(cell_fields).encode(), CF, time)
    if rc != 0:
        raise OSError(f"native vtu_write could not open {path!r}")
