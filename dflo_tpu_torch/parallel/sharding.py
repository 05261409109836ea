"""Domain decomposition over a mesh of devices, driven by one process.

The torch counterpart of dflo_tpu/parallel/sharding.py.  The JAX package
places the state ``u[4, K, ny, nx]`` on a 2-D ('dy', 'dx') device mesh and
runs ``shard_map`` from one controller; here one Python process holds the
state as a row-major list of ``DY x DX`` blocks ``[4, K, ly, lx]``, block
``(iy, ix)`` on ``DeviceMesh.devices[iy][ix]``:

- the halo exchange (the JAX path's ``ppermute`` of edge traces, the
  reference's ``update_ghost_values``, src_mpi/claw.cc:793) hands each block
  its four neighbors' edge DoF lines (:func:`exchange_halos`), moved with
  ``Tensor.to(dst, non_blocking=True)``: a peer copy between cards, a
  contiguous copy of the line on one card;
- cross-block scalars (the CFL wave speed, the negativity minimum; ``pmax``
  and ``pmin`` in the JAX path, ``MPI::min`` in the reference) reduce on the
  first block's device (:func:`reduce_max`, :func:`reduce_min`), without a
  host sync.

Devices may repeat in the grid: four blocks on one card form a virtual mesh,
the counterpart of the JAX tests' virtual CPU devices.  The port's kernels
take any block shape, so a split needs only ``ny % DY == nx % DX == 0``; the
JAX package's sharded kernels also need ``(ny/DY) % 8 == 0`` and
``(nx/DX) % 128 == 0`` (dflo_tpu/driver.py:92-97) and run XLA otherwise.
One process per card under ``torch.distributed`` (the multi-host idiom),
the multi-slice mesh and the flat-cell sharding are not ported (slice G,
the rest of multi-GPU, ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A ``DY x DX`` grid of devices: ``devices[iy][ix]`` holds block
    (iy, ix) of the state (row iy of cells from the south, column ix from
    the west)."""

    shape: tuple[int, int]
    devices: tuple[tuple[torch.device, ...], ...]

    def __post_init__(self):
        if (len(self.devices) != self.shape[0]
                or any(len(r) != self.shape[1] for r in self.devices)):
            raise ValueError(f"device grid does not have shape {self.shape}")

    @property
    def flat(self) -> list[torch.device]:
        """The devices in block order (row-major)."""
        return [d for row in self.devices for d in row]


def _visible(dev: torch.device) -> torch.device:
    """dev with its card index; raises for a card that is not visible."""
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"devices of type {dev.type!r} are not supported")
    n = torch.cuda.device_count()
    idx = torch.cuda.current_device() if dev.index is None and n else dev.index
    if idx is None or idx >= n:
        raise RuntimeError(
            f"the device mesh asks for {dev}, but {n} CUDA device(s) are "
            f"visible; a mesh never falls back to fewer cards")
    return torch.device("cuda", idx)


def device_mesh(shape: tuple[int, int] | None = None,
                devices=None) -> DeviceMesh:
    """A 2-D device mesh for domain decomposition.

    devices defaults to every visible card (raises if there is none); a
    device may repeat (a virtual mesh).  shape defaults to the most-square
    factorization of the device count, as dflo_tpu's device_mesh
    (mirroring p4est's balanced partition goal)."""
    if devices is None:
        n_vis = torch.cuda.device_count()
        if n_vis == 0:
            raise RuntimeError("no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(n_vis)]
    devices = [_visible(torch.device(d)) for d in devices]
    n = len(devices)
    if shape is None:
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    rows = tuple(tuple(devices[i * shape[1]:(i + 1) * shape[1]])
                 for i in range(shape[0]))
    return DeviceMesh(shape, rows)


def compatible_shape(n: int, ny: int, nx: int) -> tuple[int, int] | None:
    """Most-square (a, b) with a*b = n whose row split a divides ny and
    whose column split b divides nx (dflo_tpu's compatible_shape with one
    slice); None if no factorization divides the grid."""
    best = None
    for a in range(1, n + 1):
        if n % a:
            continue
        b = n // a
        if ny % a == 0 and nx % b == 0:
            score = abs(a - b)
            if best is None or score < best[0]:
                best = (score, (a, b))
    return best[1] if best else None


def mesh_grid_shape(dm: DeviceMesh) -> tuple[int, int]:
    """(DY, DX): the cell-grid decomposition of the mesh."""
    return dm.shape


def block_shape(dm: DeviceMesh, ny: int, nx: int) -> tuple[int, int]:
    """(ly, lx) of every block; raises unless the mesh divides the grid."""
    DY, DX = dm.shape
    if ny % DY or nx % DX:
        raise ValueError(f"mesh {ny}x{nx} not divisible by device mesh "
                         f"{DY}x{DX}")
    return ny // DY, nx // DX


def shard_state(u: torch.Tensor, dm: DeviceMesh) -> list[torch.Tensor]:
    """u[..., ny, nx] -> the row-major list of its blocks [..., ly, lx],
    each a contiguous copy on its device."""
    ly, lx = block_shape(dm, *u.shape[-2:])
    blocks = []
    for iy, row in enumerate(dm.devices):
        for ix, dev in enumerate(row):
            part = u[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx]
            blocks.append(torch.empty(part.shape, dtype=u.dtype,
                                      device=dev).copy_(part))
    return blocks


def gather_state(blocks: list[torch.Tensor], dm: DeviceMesh) -> torch.Tensor:
    """The blocks assembled into one state on the first block's device."""
    dev = blocks[0].device
    DX = dm.shape[1]
    rows = [torch.cat([b.to(dev) for b in blocks[i:i + DX]], dim=-1)
            for i in range(0, len(blocks), DX)]
    return torch.cat(rows, dim=-2)


def exchange_halos(blocks: list[torch.Tensor], dm: DeviceMesh, per_x: bool,
                   per_y: bool) -> list[tuple]:
    """For each block (row-major), its neighbors' edge DoF lines
    (hW, hE [4, K, ly]; hS, hN [4, K, lx]) on its device: hW is the west
    neighbor's east column, and so on.  A periodic axis wraps (an axis split
    into one block hands a block its own opposite edge, the single-device
    wrap); a side on a true, non-periodic domain edge gets None."""
    DY, DX = dm.shape

    def line(iy, ix, idx, dev):
        return blocks[iy * DX + ix][idx].contiguous().to(dev,
                                                         non_blocking=True)

    col_e, col_w = (Ellipsis, -1), (Ellipsis, 0)
    row_n, row_s = (Ellipsis, -1, slice(None)), (Ellipsis, 0, slice(None))
    out = []
    for iy in range(DY):
        for ix in range(DX):
            dev = blocks[iy * DX + ix].device
            hW = (line(iy, (ix - 1) % DX, col_e, dev)
                  if ix > 0 or per_x else None)
            hE = (line(iy, (ix + 1) % DX, col_w, dev)
                  if ix < DX - 1 or per_x else None)
            hS = (line((iy - 1) % DY, ix, row_n, dev)
                  if iy > 0 or per_y else None)
            hN = (line((iy + 1) % DY, ix, row_s, dev)
                  if iy < DY - 1 or per_y else None)
            out.append((hW, hE, hS, hN))
    return out


def reduce_max(vals: list[torch.Tensor]) -> torch.Tensor:
    """max over per-block 0-dim tensors, on the first one's device
    (NaN-propagating: a NaN block must reach the fatal flag)."""
    dev = vals[0].device
    return torch.amax(torch.stack([v.to(dev, non_blocking=True)
                                   for v in vals]))


def reduce_min(vals: list[torch.Tensor]) -> torch.Tensor:
    """min over per-block 0-dim tensors, on the first one's device
    (NaN-propagating)."""
    dev = vals[0].device
    return torch.amin(torch.stack([v.to(dev, non_blocking=True)
                                   for v in vals]))
