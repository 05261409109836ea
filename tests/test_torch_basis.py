"""The port's NumPy operators, mesh geometry and contractions against the JAX
package's (dflo_tpu_torch.ops / mesh against dflo_tpu.ops / mesh).

The operators are copies of the reference's NumPy builders, so they must be
bit-identical (np.array_equal).  The torch contractions are held to the JAX
einsums in float64 to 1e-14 relative (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu.mesh import CartesianMesh as JaxMesh
from dflo_tpu.ops import basis as jbasis
from dflo_tpu.ops import contract as jcontract
from dflo_tpu.ops import quadrature as jquad
from dflo_tpu_torch import interop
from dflo_tpu_torch.mesh import CartesianMesh
from dflo_tpu_torch.ops import basis as tbasis
from dflo_tpu_torch.ops import contract as tcontract
from dflo_tpu_torch.ops import quadrature as tquad
from dflo_tpu_torch.stab.positivity import _pos_points

FIELDS = ("V", "Gx", "Gy", "faceV", "wq", "wq2", "xq", "mass", "mass_full",
          "nodes", "mode_degree")
FAMILIES = ("Qk", "Pk")
DEGREES = (1, 2, 3)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("p", DEGREES)
@pytest.mark.parametrize("family", FAMILIES)
def test_basis_operators_bit_identical(family, p, field):
    a = getattr(jbasis.make_basis(family, p), field)
    b = getattr(tbasis.make_basis(family, p), field)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("p", DEGREES)
@pytest.mark.parametrize("family", FAMILIES)
def test_eval_at_positivity_points_bit_identical(family, p):
    pts = _pos_points(p)
    a = jbasis.make_basis(family, p).eval_at(pts)
    b = tbasis.make_basis(family, p).eval_at(pts)
    assert np.array_equal(a, b)
    ga = jbasis.make_basis(family, p).grad_at(pts)
    gb = tbasis.make_basis(family, p).grad_at(pts)
    assert all(np.array_equal(x, y) for x, y in zip(ga, gb))


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5))
def test_quadrature_bit_identical(n):
    for name in ("gauss", "gauss_lobatto"):
        if name == "gauss_lobatto" and n < 2:
            continue
        xa, wa = getattr(jquad, name)(n)
        xb, wb = getattr(tquad, name)(n)
        assert np.array_equal(xa, xb) and np.array_equal(wa, wb)


def test_positivity_points_q2_has_18():
    assert _pos_points(2).shape == (18, 2)


def test_mesh_geometry_bit_identical():
    basis = tbasis.make_basis("Qk", 2)
    a = JaxMesh(40, 12, 0.0, 4.0, 0.0, 1.0)
    b = CartesianMesh(40, 12, 0.0, 4.0, 0.0, 1.0)
    for attr in ("dx", "dy", "diameter_h"):
        assert getattr(a, attr) == getattr(b, attr)
    for xa, xb in zip(a.point_coords(basis.nodes), b.point_coords(basis.nodes)):
        assert np.array_equal(np.asarray(xa), np.asarray(xb))
    for side in range(4):
        for xa, xb in zip(a.face_coords(side, basis.xq),
                          b.face_coords(side, basis.xq)):
            assert np.array_equal(np.asarray(xa), np.asarray(xb))


def test_contractions_match_jax():
    """basis_apply / basis_reduce in f64, 1e-14 relative."""
    rng = np.random.default_rng(0)
    basis = tbasis.make_basis("Qk", 2)
    u = rng.standard_normal((4, basis.K, 6, 10))
    M = basis.faceV[1]
    v = basis.wq2 @ basis.V
    ut = interop.state_from_numpy(u, torch.float64, "cpu")
    for jfn, tfn, op in ((jcontract.basis_apply, tcontract.basis_apply, M),
                         (jcontract.basis_reduce, tcontract.basis_reduce, v)):
        a = np.asarray(jfn(jnp.asarray(op), jnp.asarray(u)))
        b = tfn(tcontract.as_tensor(op, torch.float64, "cpu"), ut).numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-14 * np.abs(a).max()


def test_interop_carries_a_reference_basis():
    jb = jbasis.make_basis("Qk", 2)
    b = interop.operators_from_numpy(jb)
    assert isinstance(b, tbasis.Basis) and b.is_nodal_collocated
    for f in FIELDS:
        assert np.array_equal(getattr(b, f), getattr(jb, f))
    u = np.arange(4 * 9 * 2 * 3, dtype=np.float64).reshape(4, 9, 2, 3)
    t = interop.state_from_numpy(jnp.asarray(u), torch.float32, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert np.array_equal(t.numpy(), u.astype(np.float32))
    with pytest.raises(ValueError):
        interop.state_from_numpy(u[0], torch.float64, "cpu")
