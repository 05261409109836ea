"""Meshes: the Cartesian mesh (cartesian), structured curvilinear blocks
(curvilinear) and the Gmsh .geo and .msh readers (geo, msh)."""

from dflo_tpu_torch.mesh.cartesian import CartesianMesh  # noqa: F401
