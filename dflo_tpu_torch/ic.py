"""Initial conditions onto the DG space.

The torch counterpart of dflo_tpu/ic.py's basis-dependent setter: nodal
interpolation for Qk (set_initial_condition_Qk, src/ic.cc:104-121).  The IC
callable takes torch coordinate tensors ``fn(x, y, t) -> [4, ...]``.
"""

from __future__ import annotations

import torch

from dflo_tpu_torch.ops import basis as basis_mod
from dflo_tpu_torch.ops.contract import as_tensor


def set_initial_condition(basis: basis_mod.Basis, mesh, fn, t: float = 0.0, *,
                          dtype: torch.dtype, device) -> torch.Tensor:
    """Interpolate an analytic state fn(x, y, t) -> [4, ...] onto
    u[4, K, ny, nx] (Qk / Qk_gll nodal bases)."""
    if basis.family not in ("Qk", "Qk_gll"):
        raise NotImplementedError(
            "the Pk L2 projection (src/ic.cc:128-168) comes with the MOOD "
            "slice; this slice sets nodal Qk states")
    xn, yn = mesh.point_coords(basis.nodes)
    u = fn(as_tensor(xn, dtype, device), as_tensor(yn, dtype, device), t)
    return u.to(dtype=dtype, device=device).contiguous()
