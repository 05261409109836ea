"""Gmsh .geo interpreter for transfinite block meshes.

A copy of dflo_tpu/mesh/geo.py.  The reference generates its meshes from
Gmsh .geo scripts of one family: axis-aligned transfinite rectangles
(possibly several, forming an L like examples/forward_step/step.geo) with
Physical Line boundary ids (examples/sod_shock_tube/tube.geo,
examples/double_mach_reflection/grid.geo).  Instead of the gmsh binary and
an unstructured .msh round-trip, this module interprets the .geo directly
and rasterizes the block union into the dense form: one bounding
CartesianMesh, a fluid mask and per-side boundary-id segments (the inputs
of solver/spatial.SegmentedSide).  A left-to-right chain of straight-edged
quads that is not axis-aligned (compression_corner's ramp) becomes one
curvilinear block (to_curvilinear).

Supported statements: variable assignments with Gmsh math, Point/Line/
Line Loop/Plane|Ruled Surface/Transfinite Line/Physical Line/Periodic
Line; Mesh.* options, Printf, Recombine, Transfinite Surface and comments
are ignored.  A surface bounded by Circle arcs (the gravity cases' disks)
needs the unstructured mesh and raises NotImplementedError naming slice E.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

from dflo_tpu_torch.mesh.cartesian import CartesianMesh

_GEO_FUNCS = {
    "Ceil": math.ceil, "Floor": math.floor, "Round": round,
    "Sqrt": math.sqrt, "Sin": math.sin, "Cos": math.cos, "Tan": math.tan,
    "Exp": math.exp, "Log": math.log, "Fabs": abs, "Abs": abs,
    "Pi": math.pi,
}


@dataclasses.dataclass
class GeoModel:
    points: dict          # id -> (x, y)
    lines: dict           # id -> (p1, p2)
    transfinite: dict     # line id -> n points
    physical_lines: dict  # boundary id -> [line ids]
    surfaces: list        # list of [line ids] (loops)
    periodic: list        # (line, partner) pairs
    circles: dict = dataclasses.field(default_factory=dict)
    #                     # id -> (p_start, p_center, p_end) arcs
    point_lc: dict = dataclasses.field(default_factory=dict)
    #                     # id -> characteristic length (4th Point coord)


def parse_geo(text: str) -> GeoModel:
    # strip comments
    text = re.sub(r"//.*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    model = GeoModel({}, {}, {}, {}, [], [])
    env: dict = {}
    loops: dict = {}

    for stmt in text.split(";"):
        s = stmt.strip()
        if not s:
            continue
        if s.startswith(("Mesh.", "Printf", "Recombine", "Transfinite Surface",
                         "General.")):
            continue
        m = re.match(r"Point\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            pid = int(_ev(m.group(1), env))
            coords = [_ev(c, env) for c in m.group(2).split(",")]
            model.points[pid] = (coords[0], coords[1])
            if len(coords) >= 4:
                model.point_lc[pid] = coords[3]
            continue
        m = re.match(r"Circle\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            cid = int(_ev(m.group(1), env))
            a, c, b = [int(_ev(v, env)) for v in m.group(2).split(",")]
            model.circles[cid] = (a, c, b)
            # arcs participate in loops/physical lines via their endpoints
            model.lines[cid] = (a, b)
            continue
        m = re.match(r"Line\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            lid = int(_ev(m.group(1), env))
            a, b = [int(_ev(c, env)) for c in m.group(2).split(",")]
            model.lines[lid] = (a, b)
            continue
        m = re.match(r"Line Loop\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            loops[int(_ev(m.group(1), env))] = \
                [int(_ev(c, env)) for c in m.group(2).split(",")]
            continue
        m = re.match(r"(?:Plane|Ruled)\s+Surface\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            for loop_id in (int(_ev(c, env)) for c in m.group(2).split(",")):
                model.surfaces.append(loops[loop_id])
            continue
        m = re.match(r"Transfinite Line\s*\{(.*)\}\s*=\s*(.*)", s)
        if m:
            n = int(round(_ev(m.group(2), env)))
            for lid in (int(_ev(c, env)) for c in m.group(1).split(",")):
                model.transfinite[abs(lid)] = n
            continue
        m = re.match(r"Physical Line\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            bid = int(_ev(m.group(1), env))
            model.physical_lines[bid] = \
                [abs(int(_ev(c, env))) for c in m.group(2).split(",")]
            continue
        m = re.match(r"Periodic Line\s*\{(.*)\}\s*=\s*\{(.*)\}", s)
        if m:
            a = [int(_ev(c, env)) for c in m.group(1).split(",")]
            b = [int(_ev(c, env)) for c in m.group(2).split(",")]
            model.periodic.extend(zip(a, b))
            continue
        m = re.match(r"Physical Surface\((\w+)\)\s*=\s*\{(.*)\}", s)
        if m:
            continue
        m = re.match(r"([A-Za-z_]\w*)\s*=\s*(.*)", s)
        if m:
            env[m.group(1)] = _ev(m.group(2), env)
            continue
        raise ValueError(f"unsupported .geo statement: {s[:60]!r}")
    return model


def _ev(expr: str, env: dict) -> float:
    """Evaluate a Gmsh arithmetic expression (numbers, vars, ^, functions)."""
    expr = expr.strip().replace("^", "**")
    try:
        return float(eval(expr, {"__builtins__": {}}, {**_GEO_FUNCS, **env}))
    except Exception as e:
        raise ValueError(f"cannot evaluate .geo expression {expr!r}: {e}") from None


@dataclasses.dataclass
class RasterizedDomain:
    """Dense-block form of a transfinite .geo model."""
    mesh: CartesianMesh
    mask: np.ndarray | None            # [ny, nx] fluid flags (None = all fluid)
    # per side: seg boundary ids along the side, -1 where the bbox edge is
    # not part of the domain boundary (solid region outside the L)
    side_bids: dict                    # 'W'/'E'/'S'/'N' -> np.ndarray int
    periodic_x: bool = False
    periodic_y: bool = False


def rasterize(model: GeoModel, tol: float = 1e-9) -> RasterizedDomain:
    """Turn the block union into (CartesianMesh, mask, side boundary ids)."""
    # block rectangles with per-direction cell counts
    rects = []
    for loop in model.surfaces:
        pts = set()
        for lid in loop:
            a, b = model.lines[abs(lid)]
            pts.update((a, b))
        xs = sorted({model.points[p][0] for p in pts})
        ys = sorted({model.points[p][1] for p in pts})
        if len(xs) != 2 or len(ys) != 2 or len(pts) != 4:
            raise ValueError("non-axis-aligned transfinite block; "
                             "use the curvilinear mesh path")
        # cells per direction from any transfinite horizontal/vertical edge
        nxc = nyc = None
        for lid in loop:
            a, b = model.lines[abs(lid)]
            (x1, y1), (x2, y2) = model.points[a], model.points[b]
            n = model.transfinite.get(abs(lid))
            if n is None:
                continue
            if abs(y1 - y2) < tol:
                nxc = n - 1
            elif abs(x1 - x2) < tol:
                nyc = n - 1
        if nxc is None or nyc is None:
            # no transfinite spec (unstructured .geo of a plain rectangle,
            # e.g. gravity/constant_gravity/grid_uns.geo): derive the cell
            # counts from the points' characteristic lengths
            lcs = [model.point_lc[p] for p in pts if p in model.point_lc]
            if not lcs:
                raise ValueError("block lacks transfinite point counts")
            lc = sum(lcs) / len(lcs)
            if nxc is None:
                nxc = max(1, int(round((xs[1] - xs[0]) / lc)))
            if nyc is None:
                nyc = max(1, int(round((ys[1] - ys[0]) / lc)))
        rects.append((xs[0], xs[1], ys[0], ys[1], nxc, nyc))

    hx = {round((r[1] - r[0]) / r[4], 12) for r in rects}
    hy = {round((r[3] - r[2]) / r[5], 12) for r in rects}
    if len(hx) != 1 or len(hy) != 1:
        raise ValueError("blocks have mismatched spacings; cannot rasterize "
                         "into one uniform grid")
    hx, hy = hx.pop(), hy.pop()

    x0 = min(r[0] for r in rects)
    x1 = max(r[1] for r in rects)
    y0 = min(r[2] for r in rects)
    y1 = max(r[3] for r in rects)
    nx = int(round((x1 - x0) / hx))
    ny = int(round((y1 - y0) / hy))
    mesh = CartesianMesh(nx, ny, x0, x1, y0, y1)

    xc = x0 + (np.arange(nx) + 0.5) * hx
    yc = y0 + (np.arange(ny) + 0.5) * hy
    mask = np.zeros((ny, nx), bool)
    for (rx0, rx1, ry0, ry1, _, _) in rects:
        mask |= ((xc[None, :] > rx0 - tol) & (xc[None, :] < rx1 + tol)
                 & (yc[:, None] > ry0 - tol) & (yc[:, None] < ry1 + tol))
    full = bool(mask.all())

    # map physical-line boundary ids onto the bbox sides
    side_bids = {"W": np.full(ny, -1, np.int64), "E": np.full(ny, -1, np.int64),
                 "S": np.full(nx, -1, np.int64), "N": np.full(nx, -1, np.int64)}
    for bid, lids in model.physical_lines.items():
        for lid in lids:
            a, b = model.lines[lid]
            (ax, ay), (bx, by) = model.points[a], model.points[b]
            lo, hi = min(ax, bx), max(ax, bx)
            if abs(ay - by) < tol:        # horizontal line
                sel = (xc > lo - tol) & (xc < hi + tol)
                if abs(ay - y0) < tol:
                    side_bids["S"][sel] = bid
                elif abs(ay - y1) < tol:
                    side_bids["N"][sel] = bid
                # interior horizontal walls are handled by the mask
            else:                          # vertical line
                lo, hi = min(ay, by), max(ay, by)
                sel = (yc > lo - tol) & (yc < hi + tol)
                if abs(ax - x0) < tol:
                    side_bids["W"][sel] = bid
                elif abs(ax - x1) < tol:
                    side_bids["E"][sel] = bid

    # periodicity: paired opposite bbox edges (isentropic_vortex grid.geo)
    per_x = per_y = False
    for a, b in model.periodic:
        la, lb = model.lines[abs(a)], model.lines[abs(b)]
        (ax1, ay1), (ax2, ay2) = model.points[la[0]], model.points[la[1]]
        (bx1, by1), _ = model.points[lb[0]], model.points[lb[1]]
        if abs(ax1 - ax2) < tol:          # vertical pair -> periodic in x
            per_x = True
        elif abs(ay1 - ay2) < tol:
            per_y = True

    return RasterizedDomain(mesh=mesh, mask=None if full else mask,
                            side_bids=side_bids,
                            periodic_x=per_x, periodic_y=per_y)


def to_curvilinear(model: GeoModel, tol: float = 1e-9):
    """Interpret a left-to-right CHAIN of straight-edged transfinite quads
    (compression_corner/corner.geo: a rectangle + a ramp block sharing a
    vertical edge) as ONE curvilinear block via transfinite interpolation.

    Returns (CurvilinearMesh, side_bids) with the same side-id conventions
    as RasterizedDomain."""
    import numpy as _np
    from dflo_tpu_torch.mesh.curvilinear import CurvilinearMesh

    blocks = []
    for loop in model.surfaces:
        pts = []
        for lid in loop:
            a, b = model.lines[abs(lid)]
            if lid < 0:
                a, b = b, a
            pts.append(a)
        if len(pts) != 4:
            raise ValueError("loops must have 4 edges")
        P = _np.array([model.points[p] for p in pts])    # ordered loop corners
        # force counter-clockwise orientation (signed area > 0)
        def cr(a, b):
            return float(a[0] * b[1] - a[1] * b[0])
        area2 = cr(P[1] - P[0], P[2] - P[0]) + cr(P[2] - P[0], P[3] - P[0])
        if area2 < 0:
            pts = pts[::-1]
            P = P[::-1]
        # rotate so corner 0 is bottom-left (min x+y)
        k = int(_np.argmin(P[:, 0] + P[:, 1]))
        pts = pts[k:] + pts[:k]
        P = _np.vstack([P[k:], P[:k]])
        # counts along the two directions from the transfinite line specs
        def count(a, b):
            for lid, (p, q) in model.lines.items():
                if {p, q} == {a, b} and lid in model.transfinite:
                    return model.transfinite[lid]
            raise ValueError("missing transfinite count")
        n_b = count(pts[0], pts[1])      # bottom edge (xi)
        n_r = count(pts[1], pts[2])      # right edge (eta)
        blocks.append((P, n_b, n_r))

    # order blocks left -> right, verify shared vertical edges / eta counts
    blocks.sort(key=lambda blk: blk[0][:, 0].min())
    n_eta = {b[2] for b in blocks}
    if len(n_eta) != 1:
        raise ValueError("chained blocks need a common vertical point count")
    n_eta = n_eta.pop()

    cols = []
    for bi, (P, n_b, _) in enumerate(blocks):
        xi = _np.linspace(0.0, 1.0, n_b)[None, :, None]
        eta = _np.linspace(0.0, 1.0, n_eta)[:, None, None]
        # bilinear transfinite blend of the 4 straight edges
        X = ((1 - xi) * (1 - eta) * P[0] + xi * (1 - eta) * P[1]
             + xi * eta * P[2] + (1 - xi) * eta * P[3])
        if bi > 0:
            if not _np.allclose(X[:, 0], cols[-1][:, -1], atol=1e-8):
                raise ValueError("blocks do not chain along x")
            X = X[:, 1:]
        cols.append(X)
    XY = _np.concatenate(cols, axis=1)
    mesh = CurvilinearMesh(XY[..., 0].copy(), XY[..., 1].copy())

    # boundary ids: match each boundary cell edge's midpoint to a physical line
    def seg_bid(p0, p1):
        mid = 0.5 * (_np.asarray(p0) + _np.asarray(p1))
        for bid, lids in model.physical_lines.items():
            for lid in lids:
                a, b = model.lines[lid]
                A = _np.array(model.points[a])
                B = _np.array(model.points[b])
                t = B - A
                L2 = t @ t
                s = _np.clip(((mid - A) @ t) / L2, 0.0, 1.0)
                if _np.hypot(*(A + s * t - mid)) < 1e-8:
                    return bid
        return -1

    X, Y = mesh.X, mesh.Y
    side_bids = {
        "S": _np.array([seg_bid((X[0, i], Y[0, i]), (X[0, i + 1], Y[0, i + 1]))
                        for i in range(mesh.nx)]),
        "N": _np.array([seg_bid((X[-1, i], Y[-1, i]), (X[-1, i + 1], Y[-1, i + 1]))
                        for i in range(mesh.nx)]),
        "W": _np.array([seg_bid((X[j, 0], Y[j, 0]), (X[j + 1, 0], Y[j + 1, 0]))
                        for j in range(mesh.ny)]),
        "E": _np.array([seg_bid((X[j, -1], Y[j, -1]), (X[j + 1, -1], Y[j + 1, -1]))
                        for j in range(mesh.ny)]),
    }
    return mesh, side_bids


#: what a circle-bounded .geo waits for
SLICE_E = ("a .geo surface bounded by circle arcs needs the unstructured "
           "(butterfly disk) mesh; it comes with slice E, unstructured "
           "meshes (ROADMAP)")


class UnstructuredDomain:
    """The general-quad form of a .geo model (the reference's
    mesh.unstructured path): not ported; it comes with slice E."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(SLICE_E)


def to_disk(model: GeoModel, tol: float = 1e-9):
    """The reference's butterfly O-grid of a full-circle arc loop
    (dflo_tpu/mesh/geo.py:350-381): not ported; it comes with slice E."""
    raise NotImplementedError(SLICE_E)


def load_geo(path: str):
    """A rasterized Cartesian domain, or a curvilinear chain when the
    blocks are not axis-aligned (compression_corner); a circle-bounded
    surface raises (slice E)."""
    with open(path) as f:
        model = parse_geo(f.read())
    if model.circles:
        return to_disk(model)
    try:
        return rasterize(model)
    except ValueError as e:
        if "non-axis-aligned" not in str(e):
            raise
        mesh, side_bids = to_curvilinear(model)
        return RasterizedDomain(mesh=mesh, mask=None, side_bids=side_bids)
