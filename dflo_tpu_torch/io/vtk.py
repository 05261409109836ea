"""Solution output: derived quantities and a VTU writer for Cartesian and
curvilinear meshes.

The NumPy counterpart of dflo_tpu/io/vtk.py's ``write_vtu`` (after
src/output.cc:32-107 and EulerEquations::Postprocessor,
src/equation.cc:35-187): conserved fields plus XVelocity, YVelocity,
Pressure and the schlieren field |grad rho|^2 (src/equation.cc:122-124),
one VTU file per snapshot (output/solution-NNN.vtu, as src/output.cc:95-105
names them).  Each DG cell is written as its own patch of p x p quad
subcells with values at its (p+1)^2 uniform nodes, so discontinuities at
cell interfaces render as they are (deal.II's DataOut::build_patches);
solid cells of a masked domain are left out.  On a mesh with per-cell
metric terms (a curvilinear block) the schlieren gradient inverts the
bilinear Jacobian (_physical_gradient).

The file is an appended-raw-binary VTU (UInt64 block headers, Float64
fields), written as the reference writes it (dflo_tpu/io/vtk.py:105-115):
by the native writer (dflo_tpu_torch/native vtu_write, the port's copy of
the reference's C++), or with ``writer="python"`` by _write_vtu_file,
NumPy alone, its plain version; both write the piecewise-constant cell
fields of ``extra_cell_fields`` (the CLI's mu_shock).  ``write_tecplot``
writes the same patches as an ASCII Tecplot FEQUADRILATERAL zone
(`format = tecplot`, dflo_tpu/io/vtk.py:313-352).  Everything here runs on
the host at output cadence.
"""

from __future__ import annotations

import os

import numpy as np

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.physics import euler


def _apply(M: np.ndarray, u: np.ndarray) -> np.ndarray:
    """[Q, K] x [c, K, ny, nx] -> [c, Q, ny, nx]."""
    return np.einsum("qk,ckyx->cqyx", M, u)


def derived_fields(W):
    """(XVelocity, YVelocity, Pressure) from conserved values W[4, ...]
    (src/equation.cc:113-120)."""
    vx = W[euler.MX] / W[euler.RHO]
    vy = W[euler.MY] / W[euler.RHO]
    p = (euler.GAMMA - 1.0) * (W[euler.ENE]
                               - 0.5 * (W[euler.MX]**2 + W[euler.MY]**2)
                               / W[euler.RHO])
    return vx, vy, p


def _patch_nodes(p: int) -> np.ndarray:
    """(p+1)^2 uniform reference nodes, x fastest."""
    s = np.linspace(0.0, 1.0, p + 1)
    return np.array([(a, b) for b in s for a in s])


def _physical_gradient(basis, mesh, rho, ref_pts):
    """d(rho)/dx, d(rho)/dy [M, ny, nx] at reference points in every cell
    (dflo_tpu/io/vtk.py:43-57): a Cartesian mesh divides by dx and dy, a
    mesh with per-cell metric terms (CurvilinearMesh) inverts the bilinear
    Jacobian (the schlieren postprocessor on general mappings,
    src/equation.cc:122-124)."""
    Gx, Gy = basis.grad_at(ref_pts)
    d_xi = _apply(Gx, rho[None])[0]
    d_eta = _apply(Gy, rho[None])[0]
    if hasattr(mesh, "metric"):
        x_xi, x_eta, y_xi, y_eta, detJ = mesh.metric(ref_pts)
        drdx = (y_eta * d_xi - y_xi * d_eta) / detJ
        drdy = (-x_eta * d_xi + x_xi * d_eta) / detJ
        return drdx, drdy
    return d_xi / mesh.dx, d_eta / mesh.dy


def _patch_conn(p: int, ncell: int) -> np.ndarray:
    """The p*p quad subcells of each cell's patch, [ncell * p * p, 4]
    (0-based point indices)."""
    n1 = p + 1
    sub = np.array([[j * n1 + i, j * n1 + i + 1, (j + 1) * n1 + i + 1,
                     (j + 1) * n1 + i] for j in range(p) for i in range(p)])
    return (np.arange(ncell)[:, None, None] * n1 * n1
            + sub[None]).reshape(-1, 4)


def write_vtu(path: str, basis: basis_mod.Basis, mesh, u, t: float = 0.0,
              schlieren: bool = True, mask=None, writer: str = "native",
              extra_cell_fields=None):
    """Write the DG solution u [4, K, ny, nx] (numpy) on a Cartesian or
    curvilinear mesh as a VTU file of per-cell patches; mask: optional
    [ny, nx] fluid flags, solid cells are dropped; extra_cell_fields: name
    -> [ny, nx] piecewise-constant fields (mu_shock; dflo_tpu/io/vtk.py:
    193-199), each cell's value on its p*p subcells; writer "native" (the
    C++ writer) or "python" (_write_vtu_file)."""
    u = np.asarray(u, np.float64)
    p = basis.degree
    ny, nx = u.shape[-2:]
    nodes = _patch_nodes(p)
    M = len(nodes)
    m = np.ones((ny, nx), bool) if mask is None else np.asarray(mask, bool)
    iy, ix = np.nonzero(m)
    ncell = len(iy)

    def gather(field):                               # [M, ny, nx] -> flat
        return field[:, iy, ix].T.ravel()

    xn, yn = mesh.point_coords(nodes)                # [M, ny, nx]
    pts = np.zeros((ncell * M, 3))
    pts[:, 0] = gather(xn)
    pts[:, 1] = gather(yn)

    vals = _apply(basis.eval_at(nodes), u)           # [4, M, ny, nx]
    fields = {"Density": gather(vals[euler.RHO]),
              "XMomentum": gather(vals[euler.MX]),
              "YMomentum": gather(vals[euler.MY]),
              "Energy": gather(vals[euler.ENE])}
    vx, vy, pr = derived_fields(vals)
    fields["XVelocity"] = gather(vx)
    fields["YVelocity"] = gather(vy)
    fields["Pressure"] = gather(pr)
    if schlieren:
        drdx, drdy = _physical_gradient(basis, mesh, u[euler.RHO], nodes)
        fields["schlieren_plot"] = gather(drdx**2 + drdy**2)

    conn = _patch_conn(p, ncell)
    cell_fields = {name: np.repeat(np.asarray(a, np.float64)[iy, ix], p * p)
                   for name, a in (extra_cell_fields or {}).items()}
    if writer == "native":
        from dflo_tpu_torch import native
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        native.vtu_write(path, pts, conn, fields, cell_fields, t)
    elif writer == "python":
        _write_vtu_file(path, pts, conn, fields, t, cell_fields)
    else:
        raise ValueError(f"unknown VTU writer {writer!r}")


def write_tecplot(path: str, basis: basis_mod.Basis, mesh, u,
                  t: float = 0.0, mask=None):
    """Write u [4, K, ny, nx] (numpy) as an ASCII Tecplot FEQUADRILATERAL
    zone (`format = tecplot`, src/parameters.cc:273-275; dflo_tpu/io/
    vtk.py:313-352): the VTU's per-cell patches, columns x, y, Density,
    XVelocity, YVelocity, Pressure, Energy at %.10g, then the 1-based
    connectivity; solid cells of a mask are dropped."""
    u = np.asarray(u, np.float64)
    p = basis.degree
    ny, nx = u.shape[-2:]
    nodes = _patch_nodes(p)
    M = len(nodes)
    m = np.ones((ny, nx), bool) if mask is None else np.asarray(mask, bool)
    iy, ix = np.nonzero(m)
    ncell = len(iy)
    vals = _apply(basis.eval_at(nodes), u)           # [4, M, ny, nx]
    xn, yn = mesh.point_coords(nodes)
    vx, vy, pr = derived_fields(vals)

    def gather(field):
        return field[:, iy, ix].T.ravel()

    cols = [gather(np.broadcast_to(xn, vals.shape[1:])),
            gather(np.broadcast_to(yn, vals.shape[1:])),
            gather(vals[euler.RHO]), gather(vx), gather(vy), gather(pr),
            gather(vals[euler.ENE])]
    conn = _patch_conn(p, ncell) + 1
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write('TITLE = "dflo_tpu solution"\n')
        f.write('VARIABLES = "x" "y" "Density" "XVelocity" "YVelocity" '
                '"Pressure" "Energy"\n')
        f.write(f'ZONE T="t={t}", N={ncell * M}, E={len(conn)}, '
                f'DATAPACKING=POINT, ZONETYPE=FEQUADRILATERAL, '
                f'SOLUTIONTIME={t}\n')
        np.savetxt(f, np.stack(cols, axis=1), fmt="%.10g")
        np.savetxt(f, conn, fmt="%d")


def _write_vtu_file(path, pts, conn, point_fields, t, cell_fields=None):
    """Appended-raw-binary VTU: each block is a UInt64 byte count followed
    by the little-endian data; point fields, then cell fields."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ncells, npts = len(conn), len(pts)
    blocks = [("Points", np.ascontiguousarray(pts, "<f8"), 3),
              ("connectivity", np.ascontiguousarray(conn, "<i4"), 1),
              ("offsets", np.arange(4, 4 * ncells + 1, 4, dtype="<i4"), 1),
              ("types", np.full(ncells, 9, "u1"), 1)]      # VTK_QUAD
    blocks += [(n, np.ascontiguousarray(a, "<f8"), 1)
               for n, a in point_fields.items()]
    n_point = len(blocks)
    blocks += [(n, np.ascontiguousarray(a, "<f8"), 1)
               for n, a in (cell_fields or {}).items()]
    kinds = {"<f8": "Float64", "<i4": "Int32", "|u1": "UInt8"}
    offs, off = [], 0
    for _, a, _ in blocks:
        offs.append(off)
        off += 8 + a.nbytes

    def header(i):
        name, a, ncomp = blocks[i]
        return (f'<DataArray type="{kinds[a.dtype.str]}" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="appended" '
                f'offset="{offs[i]}"/>\n')

    xml = ['<?xml version="1.0"?>\n'
           '<VTKFile type="UnstructuredGrid" version="1.0" '
           'byte_order="LittleEndian" header_type="UInt64">\n'
           '<UnstructuredGrid>\n'
           '<FieldData><DataArray type="Float64" Name="TimeValue" '
           f'NumberOfTuples="1" format="ascii">{t!r}</DataArray>'
           '</FieldData>\n'
           f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">\n'
           '<Points>\n', header(0), '</Points>\n<Cells>\n',
           header(1), header(2), header(3), '</Cells>\n<PointData>\n']
    xml += [header(i) for i in range(4, n_point)]
    xml += ['</PointData>\n<CellData>\n']
    xml += [header(i) for i in range(n_point, len(blocks))]
    xml += ['</CellData>\n</Piece>\n</UnstructuredGrid>\n'
            '<AppendedData encoding="raw">\n_']
    with open(path, "wb") as f:
        f.write("".join(xml).encode())
        for _, a, _ in blocks:
            f.write(np.uint64(a.nbytes).tobytes())
            f.write(a.tobytes())
        f.write(b"\n</AppendedData>\n</VTKFile>\n")
