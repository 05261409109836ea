"""Cartesian mesh."""

from dflo_tpu_torch.mesh.cartesian import CartesianMesh  # noqa: F401
