"""Structured Cartesian quadrilateral mesh.

A copy of dflo_tpu/mesh/cartesian.py.  Instead of an unstructured
``Triangulation`` iterated cell-by-cell (src/claw.cc:953-967), the domain is a
dense (ny, nx) grid of axis-aligned cells and the whole solver operates on
arrays shaped ``[..., ny, nx]`` — cells ARE the trailing two array axes, so
"neighbor access" is an array shift, and in the CUDA kernels one thread per
cell.  The reference's `mapping = cartesian` fast path with its square-cell
assumption (src/claw.cc:196-221) is the semantic model; general curvilinear
quads are handled by the separate curvilinear mesh (per-cell metric terms).

Cell (iy, ix) spans [x0 + ix*dx, x0 + (ix+1)*dx] x [y0 + iy*dy, ...].
Reference-cell coordinates live on [0, 1]^2 as in deal.II.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CartesianMesh:
    nx: int
    ny: int
    x0: float
    x1: float
    y0: float
    y1: float

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def dy(self) -> float:
        return (self.y1 - self.y0) / self.ny

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def diameter_h(self) -> float:
        """cell->diameter()/sqrt(dim), the h of compute_time_step_cartesian
        (src/claw.cc:495-497)."""
        return float(np.sqrt((self.dx**2 + self.dy**2) / 2.0))

    def cell_centers(self) -> tuple[np.ndarray, np.ndarray]:
        """(xc[ny, nx], yc[ny, nx]) cell-center coordinates."""
        xc = self.x0 + (np.arange(self.nx) + 0.5) * self.dx
        yc = self.y0 + (np.arange(self.ny) + 0.5) * self.dy
        return np.broadcast_to(xc[None, :], (self.ny, self.nx)).copy(), \
            np.broadcast_to(yc[:, None], (self.ny, self.nx)).copy()

    def point_coords(self, ref_pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Physical coordinates of reference points replicated in every cell.

        ref_pts : [M, 2] points on the unit reference cell.
        Returns (x[M, ny, nx], y[M, ny, nx]).
        """
        ref_pts = np.asarray(ref_pts)
        ox = self.x0 + np.arange(self.nx) * self.dx
        oy = self.y0 + np.arange(self.ny) * self.dy
        x = ox[None, None, :] + ref_pts[:, 0][:, None, None] * self.dx
        y = oy[None, :, None] + ref_pts[:, 1][:, None, None] * self.dy
        x = np.broadcast_to(x, (len(ref_pts), self.ny, self.nx))
        y = np.broadcast_to(y, (len(ref_pts), self.ny, self.nx))
        return x.copy(), y.copy()

    def face_coords(self, side: int, s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Coordinates of boundary-face quadrature points on one domain side.

        side : 0=W, 1=E, 2=S, 3=N (dflo_tpu_torch.ops.basis face ids)
        s    : [nq] 1-D reference points along the face
        Returns (x, y), each [nq, n_along] where n_along is ny for W/E, nx for S/N.
        """
        s = np.asarray(s)
        nq = len(s)
        if side in (0, 1):
            y = self.y0 + (np.arange(self.ny)[None, :] + s[:, None]) * self.dy
            x = np.full((nq, self.ny), self.x0 if side == 0 else self.x1)
            return x, y
        else:
            x = self.x0 + (np.arange(self.nx)[None, :] + s[:, None]) * self.dx
            y = np.full((nq, self.nx), self.y0 if side == 2 else self.y1)
            return x, y
