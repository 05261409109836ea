"""Initial conditions onto the DG space.

The torch counterpart of dflo_tpu/ic.py's basis-dependent setter: nodal
interpolation for Qk (set_initial_condition_Qk, src/ic.cc:104-121) and the L2
projection for the modal Pk basis (src/ic.cc:128-168).  The IC callable takes
torch coordinate tensors ``fn(x, y, t) -> [4, ...]``, e.g. a compiled .prm
expression (config/expressions).  The reference's named ICs (IC_FUNCTIONS,
IC_CELLWISE) are listed by name and raise until they are ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops import quadrature
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply


def set_initial_condition(basis: basis_mod.Basis, mesh, fn, t: float = 0.0, *,
                          dtype: torch.dtype, device) -> torch.Tensor:
    """Project an analytic state fn(x, y, t) -> [4, ...] onto u[4, K, ny, nx].

    Qk / Qk_gll: nodal interpolation.  Pk: L2 projection with QGauss(p+1),
    coef = M^-1 int f phi (the cell Jacobian cancels against M^-1)."""
    if basis.family in ("Qk", "Qk_gll"):
        xn, yn = mesh.point_coords(basis.nodes)
        u = fn(as_tensor(xn, dtype, device), as_tensor(yn, dtype, device), t)
        return u.to(dtype=dtype, device=device).contiguous()
    xq, wq = quadrature.gauss(basis.degree + 1)
    QX, QY = np.meshgrid(xq, xq, indexing="xy")
    pts = np.stack([QX.ravel(), QY.ravel()], axis=1)
    w2 = np.outer(wq, wq).ravel()
    xqq, yqq = mesh.point_coords(pts)
    f = fn(as_tensor(xqq, dtype, device), as_tensor(yqq, dtype, device), t)
    proj = as_tensor(w2[:, None] * basis.eval_at(pts), dtype, device)  # [Q, K]
    u = basis_apply(proj.T, f.to(dtype=dtype, device=device)) \
        * as_tensor(1.0 / basis.mass, dtype, device)[None, :, None, None]
    return u.contiguous()


def _not_ported(name: str):
    def make(params=None):
        raise NotImplementedError(
            f"the named initial condition {name!r} is not ported yet "
            f"(ROADMAP, modules to port, item 13: the physics envelope); "
            f"give the IC as w_0..w_3 expressions")
    return make


#: the reference's named ICs (dflo_tpu/ic.py IC_FUNCTIONS, IC_CELLWISE,
#: after src/ic.cc:104-121 and src_gll/ic.cc:226-377), by name
IC_FUNCTIONS = {name: _not_ported(name) for name in (
    "isenvort", "vortsys", "rt", "rrt", "isohydro", "polyhydro", "keplerian")}
IC_CELLWISE = {name: _not_ported(name) for name in ("shocktube", "rt_gll")}
