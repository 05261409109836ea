"""Physics monitor of the CLI: the total angular momentum
(compute_angular_momentum, src/claw.cc:602-635), the torch counterpart of
dflo_tpu/diagnostics.py's.  Solid cells of a masked domain are left out.
"""

from __future__ import annotations

import numpy as np
import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.contract import as_tensor, basis_apply
from dflo_tpu_torch.physics import euler


def angular_momentum(basis: basis_mod.Basis, mesh, u, mask=None):
    """int (x m_y - y m_x) dV over the (fluid) domain (src/claw.cc:626-630),
    a 0-dim tensor."""
    QX, QY = np.meshgrid(basis.xq, basis.xq, indexing="xy")
    pts = np.stack([QX.ravel(), QY.ravel()], axis=1)
    w2 = as_tensor(np.outer(basis.wq, basis.wq).ravel(), u.dtype, u.device)
    V = as_tensor(basis.eval_at(pts), u.dtype, u.device)
    xq, yq = (as_tensor(c, u.dtype, u.device) for c in mesh.point_coords(pts))
    m = basis_apply(V, u[euler.MX:euler.MY + 1])      # [2, Q, ny, nx]
    cross = xq * m[1] - yq * m[0]
    if mask is not None:
        cross = cross * as_tensor(mask, u.dtype, u.device)[None]
    return torch.sum(w2[:, None, None] * cross) * (mesh.dx * mesh.dy)

