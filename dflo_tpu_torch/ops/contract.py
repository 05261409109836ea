"""Basis-operator contractions on the state layout [c, K, *cells].

The torch counterparts of dflo_tpu/ops/contract.py.  Small dense operators
(face traces, lifts) are applied with ``torch.einsum`` on the operator's own
dtype and device; the reductions to one value per cell are ordered sums (see
:func:`_ordered_sum`).  Callers build operators with :func:`as_tensor` so
dtype and device are explicit.  TF32 is off (dflo_tpu_torch/__init__), so
float32 contractions run in full float32.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A float64 numpy operator (or scalar array) as a tensor of dtype on device."""
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype=dtype, device=device)


def recip(s: float, like: torch.Tensor) -> torch.Tensor:
    """1/s as a 0-dim tensor of like's dtype and device, rounded in that
    dtype: what the kernels multiply by (T(1) / T(s)) where the plain
    versions would divide by the Python scalar s.  (PyTorch itself divides
    a tensor by a Python scalar as a true division on the CPU and as a
    multiply by the reciprocal on CUDA.)"""
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return one / torch.full((), s, dtype=like.dtype, device=like.device)


def basis_apply(M: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[Q, K] x [c, K, *rest] -> [c, Q, *rest]."""
    return torch.einsum("qk,ck...->cq...", M, u)


def _ordered_sum(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i w[i] * x[i] over the leading axis of x, as one multiply and one
    add per term in index order (w[0] x[0] + w[1] x[1] + ...).

    The reductions that feed a threshold decision of the stabilization
    chain (cell averages, mean gradients, indicator traces and face
    integrals) use this form, and csrc/fused_post.cu computes them with the
    same IEEE operations in the same order (built with -fmad=false), so the
    kernel and this plain version round alike and in float32 take the same
    limiter decisions."""
    acc = w[0] * x[0]
    for i in range(1, x.shape[0]):
        acc = acc + w[i] * x[i]
    return acc


def basis_reduce(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[K] x [c, K, *rest] -> [c, *rest] (e.g. cell averages)."""
    return _ordered_sum(v, u.transpose(0, 1))


def basis_apply_ordered(M: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[Q, K] x [c, K, *rest] -> [c, Q, *rest] as ordered sums over k (one
    multiply and one add per term, in k order), whatever the shape: the
    positivity points, whose values feed the limiter's branches at the
    pressure floor, round the same in every caller and in the kernels."""
    sh = (1, M.shape[0]) + (1,) * (u.dim() - 2)
    acc = M[:, 0].view(sh) * u[:, 0:1]
    for k in range(1, M.shape[1]):
        acc = acc + M[:, k].view(sh) * u[:, k:k + 1]
    return acc


def basis_apply1(M: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[Q, K] x [K, *rest] -> [Q, *rest] (single-component variant)."""
    return torch.stack([_ordered_sum(M[q], u) for q in range(M.shape[0])])


def quad_reduce1(w: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """[Q] x [Q, *rest] -> [*rest]."""
    return _ordered_sum(w, F)
