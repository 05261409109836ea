"""Gmsh .msh reader (format 2.2 ASCII) -> rasterized Cartesian domain, and
a writer of a Cartesian grid as .msh.

A copy of dflo_tpu/mesh/msh.py.  The reference ingests Gmsh meshes through
deal.II GridIn::read_msh (src/claw.cc:956-967); this module reads the same
files and recovers the dense block structure: the quads must form a uniform
axis-aligned grid (the `mapping = cartesian` fast path the reference checks
in compute_cartesian_mesh_size, src/claw.cc:196-221), and boundary line
elements carry the physical ids that map onto the side segments.  A mesh
that is not such a raster needs the unstructured mesh: load_msh raises
NotImplementedError naming slice E.

load_msh parses with the native reader (dflo_tpu_torch.native, C++ built
at first use; a failed build raises); ``parser="python"`` takes the
pure-Python parse_msh instead, the plain version the tests hold the native
reader to.
"""

from __future__ import annotations

import numpy as np

from dflo_tpu_torch.mesh.cartesian import CartesianMesh
from dflo_tpu_torch.mesh.geo import RasterizedDomain


def parse_msh(text: str):
    """Returns (nodes[id] = (x, y), quads [(n1..n4, phys)], lines [(n1, n2, phys)])."""
    lines_iter = iter(text.splitlines())
    nodes, quads, blines = {}, [], []
    for line in lines_iter:
        tag = line.strip()
        if tag == "$MeshFormat":
            ver = next(lines_iter).split()[0]
            if not ver.startswith("2"):
                raise ValueError(f"unsupported .msh version {ver}; need 2.x")
            next(lines_iter)  # $EndMeshFormat
        elif tag == "$Nodes":
            n = int(next(lines_iter))
            for _ in range(n):
                parts = next(lines_iter).split()
                nodes[int(parts[0])] = (float(parts[1]), float(parts[2]))
            next(lines_iter)
        elif tag == "$Elements":
            n = int(next(lines_iter))
            for _ in range(n):
                parts = next(lines_iter).split()
                etype = int(parts[1])
                ntags = int(parts[2])
                phys = int(parts[3]) if ntags else 0
                conn = [int(v) for v in parts[3 + ntags:]]
                if etype == 1:      # 2-node line
                    blines.append((*conn, phys))
                elif etype == 3:    # 4-node quad
                    quads.append((*conn, phys))
            next(lines_iter)
    return nodes, quads, blines


def rasterize_msh(nodes, quads, blines, tol=1e-9) -> RasterizedDomain:
    """(nodes, quads, lines) of parse_msh -> the rasterized domain
    (dflo_tpu/mesh/msh.py:57-117), the quads checked and placed as arrays
    rather than one by one (the same tests, the same results)."""
    if not quads:
        raise ValueError("no quad elements in mesh")
    ids = np.fromiter(nodes, np.int64, len(nodes))
    xy = np.array([nodes[i] for i in ids.tolist()], np.float64)
    order = np.argsort(ids)
    conn = np.array([q[:4] for q in quads], np.int64)
    at = order[np.searchsorted(ids, conn, sorter=order)]
    if not (ids[at] == conn).all():
        raise KeyError("a quad names a node that is not in $Nodes")
    qx, qy = xy[at, 0], xy[at, 1]                      # [n_quads, 4]
    x0, x1, y0, y1 = qx.min(), qx.max(), qy.min(), qy.max()

    # uniform spacing from the first quad
    hx = np.ptp(qx[0])
    hy = np.ptp(qy[0])
    if hx <= 0 or hy <= 0:
        raise ValueError("degenerate quad")
    nx = int(round((x1 - x0) / hx))
    ny = int(round((y1 - y0) / hy))
    mesh = CartesianMesh(nx, ny, x0, x1, y0, y1)

    # each quad's cell from its centre; verify the quad is the axis-aligned
    # cell it claims to be
    ix = ((qx.sum(axis=1) / 4.0 - x0) / hx).astype(np.int64)
    iy = ((qy.sum(axis=1) / 4.0 - y0) / hy).astype(np.int64)
    ex = x0 + ix * hx
    ey = y0 + iy * hy
    tx = tol * np.maximum(1, np.abs(ex)) + tol
    ty = tol * np.maximum(1, np.abs(ey)) + tol
    if ((np.abs(qx.min(axis=1) - ex) > tx).any()
            or (np.abs(qx.max(axis=1) - ex - hx) > tx).any()
            or (np.abs(qy.min(axis=1) - ey) > ty).any()
            or (np.abs(qy.max(axis=1) - ey - hy) > ty).any()):
        raise ValueError("non-uniform or non-axis-aligned quads; "
                         "use the curvilinear mesh path")
    mask = np.zeros((ny, nx), bool)
    mask[iy, ix] = True
    full = bool(mask.all())

    side_bids = {"W": np.full(ny, -1, np.int64), "E": np.full(ny, -1, np.int64),
                 "S": np.full(nx, -1, np.int64), "N": np.full(nx, -1, np.int64)}
    xc = x0 + (np.arange(nx) + 0.5) * hx
    yc = y0 + (np.arange(ny) + 0.5) * hy
    for (a, b, phys) in blines:
        (ax, ay), (bx, by) = nodes[a], nodes[b]
        if abs(ay - by) < tol:                  # horizontal
            lo, hi = min(ax, bx), max(ax, bx)
            sel = (xc > lo - tol) & (xc < hi + tol)
            if abs(ay - y0) < tol:
                side_bids["S"][sel] = phys
            elif abs(ay - y1) < tol:
                side_bids["N"][sel] = phys
        elif abs(ax - bx) < tol:                # vertical
            lo, hi = min(ay, by), max(ay, by)
            sel = (yc > lo - tol) & (yc < hi + tol)
            if abs(ax - x0) < tol:
                side_bids["W"][sel] = phys
            elif abs(ax - x1) < tol:
                side_bids["E"][sel] = phys

    return RasterizedDomain(mesh=mesh, mask=None if full else mask,
                            side_bids=side_bids)


def load_msh(path: str, parser: str = "native") -> RasterizedDomain:
    """The rasterized domain of a .msh file: parsed by the native reader
    (parser="native") or by parse_msh (parser="python").  A mesh whose
    quads are not one uniform axis-aligned grid raises NotImplementedError
    (slice E)."""
    if parser == "native":
        from dflo_tpu_torch import native
        parsed = native.msh_parse(path)
    elif parser == "python":
        with open(path) as f:
            parsed = parse_msh(f.read())
    else:
        raise ValueError(f"unknown .msh parser {parser!r}")
    try:
        return rasterize_msh(*parsed)
    except ValueError as e:
        if "non-uniform" not in str(e):
            raise
        raise NotImplementedError(
            f"{path}: the quads are not one uniform axis-aligned grid; a "
            f"general quad mesh comes with slice E, unstructured meshes "
            f"(ROADMAP)") from e


def write_msh(path: str, mesh: CartesianMesh, side_bids=None, mask=None):
    """Emit a v2.2 .msh of a Cartesian grid (round-trip testing + tooling)."""
    nx, ny = mesh.nx, mesh.ny
    side_bids = side_bids or {"W": np.full(ny, 4), "E": np.full(ny, 2),
                              "S": np.full(nx, 1), "N": np.full(nx, 3)}

    def nid(i, j):
        return j * (nx + 1) + i + 1

    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{(nx + 1) * (ny + 1)}\n")
        for j in range(ny + 1):
            for i in range(nx + 1):
                f.write(f"{nid(i, j)} {mesh.x0 + i * mesh.dx:.12g} "
                        f"{mesh.y0 + j * mesh.dy:.12g} 0\n")
        f.write("$EndNodes\n$Elements\n")
        elems = []
        for i in range(nx):
            elems.append(f"1 2 {int(side_bids['S'][i])} 0 "
                         f"{nid(i, 0)} {nid(i + 1, 0)}")
            elems.append(f"1 2 {int(side_bids['N'][i])} 0 "
                         f"{nid(i, ny)} {nid(i + 1, ny)}")
        for j in range(ny):
            elems.append(f"1 2 {int(side_bids['W'][j])} 0 "
                         f"{nid(0, j)} {nid(0, j + 1)}")
            elems.append(f"1 2 {int(side_bids['E'][j])} 0 "
                         f"{nid(nx, j)} {nid(nx, j + 1)}")
        for j in range(ny):
            for i in range(nx):
                if mask is not None and not mask[j, i]:
                    continue
                elems.append(f"3 2 100 0 {nid(i, j)} {nid(i + 1, j)} "
                             f"{nid(i + 1, j + 1)} {nid(i, j + 1)}")
        f.write(f"{len(elems)}\n")
        for k, e in enumerate(elems, 1):
            f.write(f"{k} {e}\n")
        f.write("$EndElements\n")
