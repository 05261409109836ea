"""dflo_tpu_torch — the PyTorch/CUDA port of dflo_tpu, a discontinuous-Galerkin
solver for the 2-D compressible Euler equations on Cartesian meshes and
structured curvilinear blocks.

The JAX package ``dflo_tpu`` is the reference; this package imports ``torch``
and never ``jax``.  It keeps the reference's state layout ``U[4, K, ny, nx]``
with components (x-momentum, y-momentum, density, energy), so the two packages
compare array to array.  Its hot paths (RK on nodal Qk, GLL and modal Pk
at degrees 1-6 on any quadrature up to ``ops.kernels.NQ_MAX`` points per
direction, masked or not, with the HLLC, LxF, Roe, Steger-Warming, KFVS or
KEP flux and any source arm; MOOD on modal P1-P6; the implicit
Newton-Krylov step, whose primal residuals run the residual kernel) run
through hand-written CUDA kernels
(``dflo_tpu_torch/csrc``, loaded by
``dflo_tpu_torch.ops.kernels``); each has a plain PyTorch version beside it
that runs on CPU tensors.  ``python -m dflo_tpu_torch input.prm`` runs a
``.prm`` configuration (``dflo_tpu_torch.cli``) on a Cartesian mesh or a
mesh file (.geo, .msh, .struct: ``dflo_tpu_torch.mesh``);
``dflo_tpu_torch.parallel`` splits the RK/TVB step over a mesh of devices.

Reduced-precision products broke the DG free-stream cancellation in the
reference's history, so TF32 is switched off for matmuls and cuDNN here.
"""

import torch

__version__ = "0.1.0"

# full-f32 products everywhere (a reduced-precision einsum would break the
# free-stream cancellation the limiters key on)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from dflo_tpu_torch.physics import euler  # noqa: E402,F401
from dflo_tpu_torch.mesh.cartesian import CartesianMesh  # noqa: E402,F401
