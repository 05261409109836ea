"""DG basis machinery on the unit reference cell [0,1]^2.

Three basis families, mirroring the reference's capabilities:

- ``Qk``      : nodal Lagrange on (p+1) Gauss points (src/main.cc:40,
                FE_DGQArbitraryNodes(QGauss)). Mass matrix diagonal under the
                collocated Gauss quadrature (src/claw.cc:228-258).
- ``Qk_gll``  : nodal Lagrange on (p+1) Gauss-Lobatto points (src_gll/main.cc:39),
                with lumped-diagonal or consistent mass matrix
                (src_gll/parameters.cc:342).
- ``Pk``      : modal Legendre, L2-orthonormal on the unit cell, total degree
                <= p, ordering (i,j) with j outer / i inner to match the
                reference's index_to_degree map (src/claw.cc:104-118).

All operators are small dense float64 numpy matrices built once at setup; the
solver contracts them against the big state arrays with torch.einsum, or the
CUDA kernels read them from one small device buffer.  A copy of
dflo_tpu/ops/basis.py: the operators must be bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dflo_tpu_torch.ops import quadrature


# ----------------------------------------------------------------------------
# 1-D polynomial helpers (float64 numpy, setup time only)
# ----------------------------------------------------------------------------

def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis on `nodes` at points `x`: out[q, i] = l_i(x_q)."""
    n = len(nodes)
    out = np.ones((len(x), n))
    for i in range(n):
        for m in range(n):
            if m != i:
                out[:, i] *= (x - nodes[m]) / (nodes[i] - nodes[m])
    return out


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Derivatives of the Lagrange basis at points `x`: out[q, i] = l_i'(x_q)."""
    n = len(nodes)
    out = np.zeros((len(x), n))
    for i in range(n):
        for k in range(n):
            if k == i:
                continue
            term = np.ones(len(x)) / (nodes[i] - nodes[k])
            for m in range(n):
                if m != i and m != k:
                    term *= (x - nodes[m]) / (nodes[i] - nodes[m])
            out[:, i] += term
    return out


def legendre_values(p: int, x: np.ndarray) -> np.ndarray:
    """L2-orthonormal Legendre on [0,1]: out[q, n] = sqrt(2n+1) P_n(2x-1), n=0..p."""
    out = np.zeros((len(x), p + 1))
    for n in range(p + 1):
        Pn = np.polynomial.legendre.Legendre.basis(n)(2.0 * x - 1.0)
        out[:, n] = np.sqrt(2.0 * n + 1.0) * Pn
    return out


def legendre_derivatives(p: int, x: np.ndarray) -> np.ndarray:
    """d/dx of the orthonormal Legendre family on [0,1]."""
    out = np.zeros((len(x), p + 1))
    for n in range(p + 1):
        dPn = np.polynomial.legendre.Legendre.basis(n).deriv()(2.0 * x - 1.0)
        out[:, n] = 2.0 * np.sqrt(2.0 * n + 1.0) * dPn
    return out


# ----------------------------------------------------------------------------
# Basis container
# ----------------------------------------------------------------------------

# face ids, consistent everywhere in the package
WEST, EAST, SOUTH, NORTH = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Basis:
    """Reference-cell operators for one (family, degree) pair.

    Attributes
    ----------
    V     : [Q, K] basis values at the Q = nq*nq volume quadrature points.
    Gx,Gy : [Q, K] reference-coordinate gradients at volume quadrature points.
    wq2   : [Q]    tensor-product volume quadrature weights (sum = 1).
    xq,wq : [nq]   1-D quadrature points/weights on [0,1].
    faceV : [4, nq, K] traces at faces (W,E,S,N) evaluated at the 1-D
            quadrature points running along the face.
    mass  : [K]    diagonal reference mass (exact for Pk; collocation-diagonal
            for Qk-Gauss; GLL-lumped for Qk-GLL).
    mass_full : [K, K] consistent reference mass matrix (for the GLL
            `mass matrix = full` option, src_gll/parameters.cc:342).
    nodes : [K, 2] nodal support points (Qk families; Pk: quadrature points,
            used only for plotting).
    mode_degree : [K] total polynomial degree of each basis function
            (drives Pk MOOD truncation, src/claw.cc:104-118).
    """

    family: str
    degree: int
    nq: int
    K: int
    V: np.ndarray
    Gx: np.ndarray
    Gy: np.ndarray
    wq2: np.ndarray
    xq: np.ndarray
    wq: np.ndarray
    faceV: np.ndarray
    mass: np.ndarray
    mass_full: np.ndarray
    nodes: np.ndarray
    mode_degree: np.ndarray

    @property
    def is_nodal_collocated(self) -> bool:
        """True when V == I (solution values at quad points are the DoFs):
        Qk on its Gauss nodes, Qk_gll on its Gauss-Lobatto nodes
        (src_gll/assemble_explicit.cc:66-72)."""
        return self.family in ("Qk", "Qk_gll") and self.nq == self.degree + 1

    # -- generic evaluation at arbitrary reference points ---------------------
    def eval_at(self, pts: np.ndarray) -> np.ndarray:
        """Basis values at arbitrary reference points pts[m, 2] -> [m, K]."""
        return _eval_matrix(self.family, self.degree, pts)

    def grad_at(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Basis reference gradients at pts[m, 2] -> ([m, K], [m, K])."""
        return _grad_matrix(self.family, self.degree, pts)


def _qk_index(n: int) -> list[tuple[int, int]]:
    # deal.II DGQ lexicographic ordering: x fastest
    return [(i, j) for j in range(n) for i in range(n)]


def _pk_index(p: int) -> list[tuple[int, int]]:
    # reference ordering, src/claw.cc:109-113: j outer, i in 0..p-j
    return [(i, j) for j in range(p + 1) for i in range(p + 1 - j)]


def _eval_matrix(family: str, p: int, pts: np.ndarray) -> np.ndarray:
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    if family in ("Qk", "Qk_gll"):
        nodes1d = (quadrature.gauss(p + 1)[0] if family == "Qk"
                   else quadrature.gauss_lobatto(p + 1)[0])
        lx = lagrange_values(nodes1d, pts[:, 0])
        ly = lagrange_values(nodes1d, pts[:, 1])
        idx = _qk_index(p + 1)
    else:
        lx = legendre_values(p, pts[:, 0])
        ly = legendre_values(p, pts[:, 1])
        idx = _pk_index(p)
    return np.stack([lx[:, i] * ly[:, j] for (i, j) in idx], axis=1)


def _grad_matrix(family: str, p: int, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    if family in ("Qk", "Qk_gll"):
        nodes1d = (quadrature.gauss(p + 1)[0] if family == "Qk"
                   else quadrature.gauss_lobatto(p + 1)[0])
        lx = lagrange_values(nodes1d, pts[:, 0])
        ly = lagrange_values(nodes1d, pts[:, 1])
        dx = lagrange_derivatives(nodes1d, pts[:, 0])
        dy = lagrange_derivatives(nodes1d, pts[:, 1])
        idx = _qk_index(p + 1)
    else:
        lx = legendre_values(p, pts[:, 0])
        ly = legendre_values(p, pts[:, 1])
        dx = legendre_derivatives(p, pts[:, 0])
        dy = legendre_derivatives(p, pts[:, 1])
        idx = _pk_index(p)
    gx = np.stack([dx[:, i] * ly[:, j] for (i, j) in idx], axis=1)
    gy = np.stack([lx[:, i] * dy[:, j] for (i, j) in idx], axis=1)
    return gx, gy


def make_basis(family: str, degree: int, nq: int | None = None) -> Basis:
    """Build the reference-cell operator set for (family, degree).

    nq defaults to degree+1 Gauss points, matching the reference's assembly
    quadrature (src/claw.cc:394,419).  The Qk_gll family instead collocates
    on degree+1 Gauss-Lobatto points (quadrature points = nodes, V = I) —
    the src_gll scheme whose lumped mass and nodal source discretization the
    well-balanced gravity forms rely on (src_gll/assemble_explicit.cc:30-135).
    """
    if family not in ("Qk", "Qk_gll", "Pk"):
        raise ValueError(f"unknown basis family {family!r}")
    p = int(degree)
    nq = nq or (p + 1)
    if family == "Qk_gll" and nq == p + 1:
        xq, wq = quadrature.gauss_lobatto(nq)
    else:
        xq, wq = quadrature.gauss(nq)

    # volume quad grid, x fastest
    QX, QY = np.meshgrid(xq, xq, indexing="xy")  # QY[j,i]=xq[j], QX[j,i]=xq[i]
    pts = np.stack([QX.ravel(), QY.ravel()], axis=1)  # q = j*nq + i
    wq2 = np.outer(wq, wq).ravel()

    V = _eval_matrix(family, p, pts)
    Gx, Gy = _grad_matrix(family, p, pts)
    K = V.shape[1]

    # face traces: 1-D quad points run along the face coordinate
    s = xq
    facepts = {
        WEST: np.stack([np.zeros(nq), s], axis=1),
        EAST: np.stack([np.ones(nq), s], axis=1),
        SOUTH: np.stack([s, np.zeros(nq)], axis=1),
        NORTH: np.stack([s, np.ones(nq)], axis=1),
    }
    faceV = np.stack([_eval_matrix(family, p, facepts[f]) for f in range(4)])

    # mass matrices on the reference cell; the consistent matrix is always
    # integrated exactly with a (p+1)-point Gauss rule (degree-2p integrand),
    # independent of the assembly quadrature
    xe, we = quadrature.gauss(p + 1)
    QXe, QYe = np.meshgrid(xe, xe, indexing="xy")
    Ve = _eval_matrix(family, p, np.stack([QXe.ravel(), QYe.ravel()], axis=1))
    w2e = np.outer(we, we).ravel()
    mass_full = (Ve * w2e[:, None]).T @ Ve
    if family == "Qk":
        # collocated Gauss: diagonal by construction (src/claw.cc:228-258)
        mass = np.diag(mass_full).copy()
    elif family == "Pk":
        mass = np.ones(K)  # orthonormal
    else:
        # GLL lumping: integrate phi_i^2 with the GLL rule itself -> w_i w_j
        # (mass matrix = diagonal, src_gll/claw.cc:233-262)
        xg, wg = quadrature.gauss_lobatto(p + 1)
        idx = _qk_index(p + 1)
        mass = np.array([wg[i] * wg[j] for (i, j) in idx])

    # nodal support points
    if family in ("Qk", "Qk_gll"):
        nodes1d = (quadrature.gauss(p + 1)[0] if family == "Qk"
                   else quadrature.gauss_lobatto(p + 1)[0])
        nodes = np.array([(nodes1d[i], nodes1d[j]) for (i, j) in _qk_index(p + 1)])
        mode_degree = np.array([max(i, j) for (i, j) in _qk_index(p + 1)])
    else:
        nodes = pts.copy()
        mode_degree = np.array([i + j for (i, j) in _pk_index(p)])

    return Basis(family=family, degree=p, nq=nq, K=K, V=V, Gx=Gx, Gy=Gy,
                 wq2=wq2, xq=xq, wq=wq, faceV=faceV, mass=mass,
                 mass_full=mass_full, nodes=nodes, mode_degree=mode_degree)


def qk_reduction_matrices(basis: Basis) -> np.ndarray:
    """MOOD degree-reduction operators for Qk (src/mood.cc:48-70).

    R[d] maps nodal coefficients of degree p onto the degree-d interpolant
    re-expanded on the degree-p nodes: R[d] = E_{d->p} @ I_{p->d}, where
    I interpolates at the coarse nodes and E evaluates back at the fine nodes.
    Returns [p, K, K] (entry d reduces to degree d, d = 0..p-1).
    """
    p = basis.degree
    fam = basis.family
    out = np.zeros((p, basis.K, basis.K))
    fine_nodes = basis.nodes
    for d in range(p):
        coarse = make_basis(fam, d)
        # interpolate fine solution at coarse nodes: [K_d, K]
        I = _eval_matrix(fam, p, coarse.nodes)
        # evaluate coarse basis at fine nodes: [K, K_d]
        E = _eval_matrix(fam, d, fine_nodes)
        out[d] = E @ I
    return out
