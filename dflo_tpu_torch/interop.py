"""Carry the JAX package's arrays into the port.

The two packages share no code at run time (the port never imports JAX), so
tests hand the reference's arrays across as numpy: the state with
:func:`state_from_numpy`, and a reference ``Basis`` (any object with its
fields) with :func:`operators_from_numpy`.  Both packages then compute from
identical inputs.  The MOOD cascade's degree (int32) and limiter-mark
(bool) planes and its MoodStats cross the same way
(:func:`planes_from_numpy`, :func:`stats_as_numpy`).  Meshes cross as their
arrays: a reference ``CartesianMesh`` or ``CurvilinearMesh``
(:func:`mesh_from_numpy`), a
``RasterizedDomain`` of a .geo or .msh file (:func:`domain_from_numpy`),
and a ``SegmentedSide`` from its ``seg_id`` with the port's own boundary
sides for its segments (:func:`segmented_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dflo_tpu_torch.mesh.cartesian import CartesianMesh
from dflo_tpu_torch.mesh.curvilinear import CurvilinearMesh
from dflo_tpu_torch.mesh.geo import RasterizedDomain
from dflo_tpu_torch.ops.basis import Basis
from dflo_tpu_torch.solver.spatial import SegmentedSide


def state_from_numpy(u_np, dtype: torch.dtype, device) -> torch.Tensor:
    """[4, K, ny, nx] numpy state (or anything np.asarray takes) -> tensor."""
    u = np.asarray(u_np)
    if u.ndim != 4 or u.shape[0] != 4:
        raise ValueError(f"expected a [4, K, ny, nx] state, got {u.shape}")
    # np.array copies: a JAX array's numpy view is read-only
    return torch.from_numpy(np.array(u, order="C")).to(dtype=dtype,
                                                       device=device)


def operators_from_numpy(basis_like) -> Basis:
    """The port's Basis from the arrays of a reference Basis."""
    kw = {}
    for f in dataclasses.fields(Basis):
        v = getattr(basis_like, f.name)
        kw[f.name] = v if f.name in ("family", "degree", "nq", "K") \
            else np.array(v)
    return Basis(**kw)


def planes_from_numpy(deg_np, lim_np, device) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """[ny, nx] degree and limiter-mark planes -> (int32, bool) tensors."""
    deg = torch.from_numpy(np.array(deg_np, np.int32))
    lim = torch.from_numpy(np.array(lim_np, bool))
    return deg.to(device), lim.to(device)


def stats_as_numpy(stats) -> np.ndarray:
    """(n_reduce, n_marked, iters) of either package's MoodStats as an
    int64 array."""
    return np.array([int(np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                    else v)) for v in stats], np.int64)


def mesh_from_numpy(mesh_like):
    """A reference CartesianMesh (its six numbers) or CurvilinearMesh (its
    node arrays X, Y) as the port's."""
    if hasattr(mesh_like, "metric"):
        return CurvilinearMesh(np.array(mesh_like.X, np.float64),
                               np.array(mesh_like.Y, np.float64))
    return CartesianMesh(int(mesh_like.nx), int(mesh_like.ny),
                         float(mesh_like.x0), float(mesh_like.x1),
                         float(mesh_like.y0), float(mesh_like.y1))


def domain_from_numpy(dom_like) -> RasterizedDomain:
    """The port's RasterizedDomain from a reference one: its mesh, fluid
    mask and per-side boundary ids as arrays."""
    mask = None if dom_like.mask is None else np.array(dom_like.mask, bool)
    return RasterizedDomain(
        mesh=mesh_from_numpy(dom_like.mesh), mask=mask,
        side_bids={k: np.array(v, np.int64)
                   for k, v in dom_like.side_bids.items()},
        periodic_x=bool(dom_like.periodic_x),
        periodic_y=bool(dom_like.periodic_y))


def segmented_from_numpy(seg_id, segments) -> SegmentedSide:
    """A SegmentedSide from a reference side's seg_id and the port's
    BoundarySides for its segments (the reference's boundary values are
    JAX callables, which the port does not call)."""
    return SegmentedSide(np.array(seg_id, np.int32), tuple(segments))
