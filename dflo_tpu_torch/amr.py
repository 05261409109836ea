"""Transfer operators between a Cartesian mesh and its 2x refinement.

The part of dflo_tpu/amr.py that grid-sequenced steady solves need
(solver/implicit.run_steady_sequenced, dflo_tpu/amr.py:49-132): the exact
prolongation of a coarse state to the four children of each cell and the
conservative L2 restriction back.  The rest of AMR comes with slice F.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import quadrature
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply


def child_ref_pts(pts: np.ndarray, a: int, b: int) -> np.ndarray:
    """Map child-(a, b) reference points into the parent cell."""
    return np.stack([(a + pts[:, 0]) / 2.0, (b + pts[:, 1]) / 2.0], axis=1)


def prolong_matrices(basis: basis_mod.Basis) -> list:
    """P[b][a] with u_child = P @ u_parent: the parent polynomial at the
    child's nodes (nodal bases) or its L2 projection onto the child basis
    (Pk) (SolutionTransfer interpolation, src/refine.cc:100-104)."""
    out = [[None, None], [None, None]]
    if basis.family == "Pk":
        xq, wq = quadrature.gauss(basis.degree + 1)
        QX, QY = np.meshgrid(xq, xq, indexing="xy")
        pts = np.stack([QX.ravel(), QY.ravel()], axis=1)
        w2 = np.outer(wq, wq).ravel()
        Vc = basis.eval_at(pts)
        Minv = np.linalg.inv(basis.mass_full)
        for b in range(2):
            for a in range(2):
                Vp = basis.eval_at(child_ref_pts(pts, a, b))
                out[b][a] = Minv @ (Vc * w2[:, None]).T @ Vp
    else:
        for b in range(2):
            for a in range(2):
                out[b][a] = basis.eval_at(child_ref_pts(basis.nodes, a, b))
    return out


def restrict_matrices(basis: basis_mod.Basis) -> list:
    """R[b][a] with u_parent = sum over the children of R @ u_child: the L2
    projection of the four children onto the parent (conservative: the
    parent's mean is the children's)."""
    xq, wq = quadrature.gauss(basis.degree + 1)
    QX, QY = np.meshgrid(xq, xq, indexing="xy")
    pts = np.stack([QX.ravel(), QY.ravel()], axis=1)
    w2 = np.outer(wq, wq).ravel()
    Vc = basis.eval_at(pts)
    Minv = np.linalg.inv(basis.mass_full)
    out = [[None, None], [None, None]]
    for b in range(2):
        for a in range(2):
            Vp = basis.eval_at(child_ref_pts(pts, a, b))
            # 1/4: the child's area fraction of the parent reference cell
            out[b][a] = Minv @ (0.25 * (Vp * w2[:, None]).T @ Vc)
    return out


def make_prolong(basis: basis_mod.Basis, dtype: torch.dtype, device):
    """prolong(uc): [4, K, ny, nx] -> [4, K, 2ny, 2nx]."""
    P = prolong_matrices(basis)
    P = [[as_tensor(P[b][a], dtype, device) for a in range(2)]
         for b in range(2)]

    def prolong(uc):
        c, K, ny, nx = uc.shape
        uf = uc.new_zeros((c, K, 2 * ny, 2 * nx))
        for b in range(2):
            for a in range(2):
                uf[:, :, b::2, a::2] = basis_apply(P[b][a], uc)
        return uf

    return prolong


def make_restrict(basis: basis_mod.Basis, dtype: torch.dtype, device):
    """restrict(uf): [4, K, 2ny, 2nx] -> [4, K, ny, nx]."""
    R = restrict_matrices(basis)
    R = [[as_tensor(R[b][a], dtype, device) for a in range(2)]
         for b in range(2)]

    def restrict(uf):
        acc = None
        for b in range(2):
            for a in range(2):
                term = basis_apply(R[b][a], uf[:, :, b::2, a::2])
                acc = term if acc is None else acc + term
        return acc.contiguous()

    return restrict
