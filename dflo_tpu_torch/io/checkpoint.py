"""Checkpoint / resume, in the .npz format of dflo_tpu/io/checkpoint.py
(a checkpoint of either package resumes in the other).

The reference has NO restart capability (SURVEY.md §5.4: output is
visualization-only, src/output.cc writes and nothing reads).  The pure-array
state of the TPU design makes real checkpointing trivial, so we add it:
solution array + time + iteration + discretization metadata in one npz, with
an integrity check on reload.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, u, t: float, it: int, *, basis=None,
                    mesh=None, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {}
    if basis is not None:
        meta.update(family=basis.family, degree=basis.degree)
    if mesh is not None:
        if hasattr(mesh, "metric"):
            # a curvilinear block has no box: its cell counts alone (the
            # reference's save_checkpoint reads x0 and raises there)
            meta.update(nx=mesh.nx, ny=mesh.ny)
        elif hasattr(mesh, "nx"):
            meta.update(nx=mesh.nx, ny=mesh.ny, x0=mesh.x0, x1=mesh.x1,
                        y0=mesh.y0, y1=mesh.y1)
        else:   # unstructured flat-cell mesh
            meta.update(n_cells=mesh.n_cells)
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    np.savez_compressed(path, u=np.asarray(u), t=float(t), it=int(it),
                        **meta, **(extra or {}))


def load_checkpoint(path: str, *, basis=None, mesh=None):
    """Returns (u as numpy, t, it, meta-dict).  If basis/mesh are given,
    their signature is validated against the stored metadata."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    u = data.pop("u")
    t = float(data.pop("t"))
    it = int(data.pop("it"))
    if basis is not None:
        if str(data.get("family")) != basis.family \
                or int(data.get("degree")) != basis.degree:
            raise ValueError(
                f"checkpoint basis {data.get('family')}{data.get('degree')} "
                f"does not match solver {basis.family}{basis.degree}")
    if mesh is not None:
        if hasattr(mesh, "nx"):
            if int(data.get("nx")) != mesh.nx \
                    or int(data.get("ny")) != mesh.ny:
                raise ValueError("checkpoint mesh size mismatch")
        elif "n_cells" in data and int(data["n_cells"]) != mesh.n_cells:
            raise ValueError("checkpoint mesh size mismatch")
    return u, t, it, data
