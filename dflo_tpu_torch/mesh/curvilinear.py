"""Structured curvilinear quadrilateral block meshes.

A copy of dflo_tpu/mesh/curvilinear.py (NumPy geometry, as there).  It
handles the reference's general-quad cases (`mapping = q1`,
src/parameters.cc:489-497): naca0012's structured O-mesh (naca.struct),
the annulus meshes of the radial gravity cases and compression_corner's
slanted block.  A block is an (ny+1) x (nx+1) array of node coordinates;
each cell is the bilinear (Q1) image of the unit square, deal.II's
MappingQ1, so edges are straight, per-edge normals are constant, and the
per-cell metric terms (Jacobian matrix, detJ) are polynomial fields
computed once at the quadrature points.

The solution layout is the Cartesian path's: u[4, K, ny, nx] with cells as
trailing array axes; only the metric weights differ
(solver/spatial_curvi.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CurvilinearMesh:
    """X[ny+1, nx+1], Y[ny+1, nx+1] node coordinates."""
    X: np.ndarray
    Y: np.ndarray

    @property
    def nx(self) -> int:
        return self.X.shape[1] - 1

    @property
    def ny(self) -> int:
        return self.X.shape[0] - 1

    # ---- corner helpers --------------------------------------------------
    def corners(self):
        """(x00, x10, x01, x11), each [ny, nx] pairs of (x, y) arrays;
        index = (xi, eta) corner of each cell."""
        X, Y = self.X, self.Y
        return ((X[:-1, :-1], Y[:-1, :-1]), (X[:-1, 1:], Y[:-1, 1:]),
                (X[1:, :-1], Y[1:, :-1]), (X[1:, 1:], Y[1:, 1:]))

    def point_coords(self, ref_pts: np.ndarray):
        """Physical coordinates of reference points in every cell:
        ref_pts [M, 2] -> (x[M, ny, nx], y[M, ny, nx]) via the bilinear map."""
        (x00, y00), (x10, y10), (x01, y01), (x11, y11) = self.corners()
        xi = np.asarray(ref_pts)[:, 0][:, None, None]
        eta = np.asarray(ref_pts)[:, 1][:, None, None]
        x = ((1 - xi) * (1 - eta) * x00 + xi * (1 - eta) * x10
             + (1 - xi) * eta * x01 + xi * eta * x11)
        y = ((1 - xi) * (1 - eta) * y00 + xi * (1 - eta) * y10
             + (1 - xi) * eta * y01 + xi * eta * y11)
        return x, y

    def metric(self, ref_pts: np.ndarray):
        """Jacobian entries at reference points in every cell:
        (x_xi, x_eta, y_xi, y_eta, detJ), each [M, ny, nx]."""
        (x00, y00), (x10, y10), (x01, y01), (x11, y11) = self.corners()
        xi = np.asarray(ref_pts)[:, 0][:, None, None]
        eta = np.asarray(ref_pts)[:, 1][:, None, None]
        x_xi = (1 - eta) * (x10 - x00) + eta * (x11 - x01)
        x_eta = (1 - xi) * (x01 - x00) + xi * (x11 - x10)
        y_xi = (1 - eta) * (y10 - y00) + eta * (y11 - y01)
        y_eta = (1 - xi) * (y01 - y00) + xi * (y11 - y10)
        detJ = x_xi * y_eta - x_eta * y_xi
        return x_xi, x_eta, y_xi, y_eta, detJ

    def x_edges(self):
        """Constant-xi interfaces (nx+1 per row): unit normals (+xi
        orientation) and lengths.  Returns (nx_, ny_, L), each [ny, nx+1]."""
        ex = self.X[1:, :] - self.X[:-1, :]
        ey = self.Y[1:, :] - self.Y[:-1, :]
        L = np.hypot(ex, ey)
        return ey / L, -ex / L, L

    def y_edges(self):
        """Constant-eta interfaces (ny+1 per column): unit normals (+eta
        orientation) and lengths.  Returns (nx_, ny_, L), each [ny+1, nx]."""
        ex = self.X[:, 1:] - self.X[:, :-1]
        ey = self.Y[:, 1:] - self.Y[:, :-1]
        L = np.hypot(ex, ey)
        return -ey / L, ex / L, L

    def face_coords(self, side: int, s: np.ndarray):
        """Boundary-face quadrature coordinates (cf. CartesianMesh)."""
        s = np.asarray(s)
        if side == 0:      # W: xi = 0 edge of column 0
            x0, y0 = self.X[:-1, 0], self.Y[:-1, 0]
            x1, y1 = self.X[1:, 0], self.Y[1:, 0]
        elif side == 1:    # E
            x0, y0 = self.X[:-1, -1], self.Y[:-1, -1]
            x1, y1 = self.X[1:, -1], self.Y[1:, -1]
        elif side == 2:    # S
            x0, y0 = self.X[0, :-1], self.Y[0, :-1]
            x1, y1 = self.X[0, 1:], self.Y[0, 1:]
        else:              # N
            x0, y0 = self.X[-1, :-1], self.Y[-1, :-1]
            x1, y1 = self.X[-1, 1:], self.Y[-1, 1:]
        x = x0[None, :] + s[:, None] * (x1 - x0)[None, :]
        y = y0[None, :] + s[:, None] * (y1 - y0)[None, :]
        return x, y

    def cell_h(self) -> np.ndarray:
        """diameter/sqrt(dim) per cell (compute_time_step_q,
        src/claw.cc:544-546)."""
        (x00, y00), (x10, y10), (x01, y01), (x11, y11) = self.corners()
        d1 = np.hypot(x11 - x00, y11 - y00)
        d2 = np.hypot(x10 - x01, y10 - y01)
        return np.maximum(d1, d2) / np.sqrt(2.0)

    def cell_centers(self):
        x, y = self.point_coords(np.array([[0.5, 0.5]]))
        return x[0], y[0]


def annulus_mesh(r_in: float, r_out: float, n_r: int, n_theta: int,
                 theta0: float = 0.0, theta1: float = 2.0 * np.pi,
                 full: bool | None = None) -> CurvilinearMesh:
    """Polar annulus block (the radial gravity meshes,
    examples/gravity/radial_gravity/grid_uns.geo): xi = theta, eta = r.
    For a full annulus pair it with periodic W/E BCs."""
    # theta runs CLOCKWISE along xi so that (e_xi, e_eta) is right-handed
    # (detJ > 0) with eta = r pointing outward
    th = np.linspace(theta1, theta0, n_theta + 1)
    r = np.linspace(r_in, r_out, n_r + 1)
    TH, R = np.meshgrid(th, r)
    return CurvilinearMesh(R * np.cos(TH), R * np.sin(TH))


def load_struct(path: str) -> CurvilinearMesh:
    """Read a single-block structured grid in the naca.struct format
    (examples/naca0012/naca.struct; reader semantics of struct2gmsh.f:17-20):
    header `ni nj`, then ni*nj lines of `x y` with j varying fastest.
    i is the cyclic wrap direction of the O-mesh (struct2gmsh.f:31-34);
    j = 0 is the airfoil surface, j = nj-1 the farfield.  The block is
    oriented so detJ > 0."""
    with open(path) as f:
        ni, nj = (int(v) for v in f.readline().split())
        data = np.loadtxt(f)
    x = data[:, 0].reshape(ni, nj)
    y = data[:, 1].reshape(ni, nj)
    # CurvilinearMesh rows = eta = j (radial), cols = xi = i (wrap)
    X, Y = x.T.copy(), y.T.copy()
    mesh = CurvilinearMesh(X, Y)
    if float(np.min(mesh.metric(np.array([[0.5, 0.5]]))[4])) <= 0:
        mesh = CurvilinearMesh(X[:, ::-1].copy(), Y[:, ::-1].copy())
    return mesh


def wavy_mesh(nx: int, ny: int, x0: float, x1: float, y0: float, y1: float,
              amp: float = 0.05) -> CurvilinearMesh:
    """Smoothly-perturbed Cartesian grid (metric-identity testing)."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    XX, YY = np.meshgrid(xs, ys)
    Lx, Ly = x1 - x0, y1 - y0
    X = XX + amp * Lx * np.sin(2 * np.pi * (XX - x0) / Lx) \
        * np.sin(2 * np.pi * (YY - y0) / Ly)
    Y = YY + amp * Ly * np.sin(2 * np.pi * (XX - x0) / Lx) \
        * np.sin(2 * np.pi * (YY - y0) / Ly)
    # keep the boundary nodes on the original rectangle
    X[[0, -1], :] = XX[[0, -1], :]
    X[:, [0, -1]] = XX[:, [0, -1]]
    Y[[0, -1], :] = YY[[0, -1], :]
    Y[:, [0, -1]] = YY[:, [0, -1]]
    return CurvilinearMesh(X, Y)


def naca0012_omesh(n_around: int, n_out: int, farfield: float = 20.0,
                   ratio: float = 1.15) -> CurvilinearMesh:
    """A NACA 0012 O-mesh of n_around cells around and n_out out, in the
    layout load_struct gives (rows eta = the wall-normal index, columns
    xi = the wrap index, the seam column repeated).

    The airfoil is the public 4-digit thickness formula with the closed
    trailing edge (x^4 coefficient -0.1036), cosine-spaced from the
    trailing edge along the lower surface to the leading edge and back
    along the upper one (clockwise, so detJ > 0 with eta outward).  Each
    node lies on the ray from mid-chord through its surface point, out to
    a circle of `farfield` chords about mid-chord, geometrically stretched
    away from the wall by `ratio`; the airfoil is convex about mid-chord,
    so every cell has detJ > 0."""
    th = 2.0 * np.pi * np.arange(n_around + 1) / n_around
    x = 0.5 * (1.0 + np.cos(th))
    yt = 0.6 * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x**2
                + 0.2843 * x**3 - 0.1036 * x**4)
    y = np.where(th <= np.pi, -yt, yt)
    x[-1], y[-1] = x[0], y[0]                 # the seam node repeated
    dx, dy = x - 0.5, y
    r = np.hypot(dx, dy)
    fx, fy = 0.5 + farfield * dx / r, farfield * dy / r
    s = (ratio ** np.arange(n_out + 1) - 1.0) / (ratio ** n_out - 1.0)
    X = x[None, :] + s[:, None] * (fx - x)[None, :]
    Y = y[None, :] + s[:, None] * (fy - y)[None, :]
    return CurvilinearMesh(X, Y)


def write_struct(path: str, mesh: CurvilinearMesh) -> None:
    """Write a block in the naca.struct format load_struct reads: `ni nj`,
    then ni*nj lines `x y` with j (the rows) varying fastest."""
    X, Y = np.asarray(mesh.X), np.asarray(mesh.Y)
    nj, ni = X.shape
    with open(path, "w") as f:
        f.write(f"{ni} {nj}\n")
        np.savetxt(f, np.stack([X.T.ravel(), Y.T.ravel()], axis=1),
                   fmt="%.17g")
