"""The port's Euler physics and HLLC flux against the JAX package's, in
float64 on the CPU (dflo_tpu_torch.physics against dflo_tpu.physics).

Same numpy inputs through both; the tolerance is 1e-13 relative to the
largest magnitude of the reference output (round-off of a different
evaluation order at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflo_tpu.physics import euler as jeuler
from dflo_tpu.physics import fluxes as jfluxes
from dflo_tpu_torch.physics import euler as teuler
from dflo_tpu_torch.physics import fluxes as tfluxes

TOL = 1e-13
NORMALS = ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


def random_states(seed: int, n: int = 512, strong: bool = False):
    """[4, n] conserved states with positive density and pressure; strong
    adds Mach-10-like jumps (the DMR's post-shock state scale)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.2, 8.0 if strong else 2.0, n)
    vx = rng.uniform(-8.0 if strong else -2.0, 8.0 if strong else 2.0, n)
    vy = rng.uniform(-5.0 if strong else -2.0, 5.0 if strong else 2.0, n)
    p = rng.uniform(0.1, 120.0 if strong else 3.0, n)
    E = p / (jeuler.GAMMA - 1.0) + 0.5 * rho * (vx * vx + vy * vy)
    return np.stack([rho * vx, rho * vy, rho, E])


def close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    err = np.abs(a - b).max() / scale
    assert err <= tol, err


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("strong", (False, True))
@pytest.mark.parametrize("normal", NORMALS)
def test_hllc_matches_jax(normal, strong):
    UL = random_states(1, strong=strong)
    UR = random_states(2, strong=strong)
    nx, ny = normal
    a = jfluxes.hllc(jnp.asarray(UL), jnp.asarray(UR), nx, ny)
    b = tfluxes.hllc(t64(UL), t64(UR), nx, ny)
    close(a, b)


def test_hllc_consistent_and_conservative():
    """F(U, U, n) is the physical normal flux, and F(a, b, n) = -F(b, a, -n)."""
    U = t64(random_states(3, strong=True))
    close(teuler.flux_x(U).numpy(), tfluxes.hllc(U, U, 1.0, 0.0))
    close(teuler.flux_y(U).numpy(), tfluxes.hllc(U, U, 0.0, 1.0))
    V = t64(random_states(4, strong=True))
    close(tfluxes.hllc(U, V, 1.0, 0.0).numpy(),
          -tfluxes.hllc(V, U, -1.0, 0.0), tol=1e-12)


@pytest.mark.parametrize("fn", ("pressure", "sound_speed", "flux_x", "flux_y",
                                "kinetic_energy"))
def test_pointwise_physics_matches_jax(fn):
    U = random_states(5, strong=True)
    close(getattr(jeuler, fn)(jnp.asarray(U)), getattr(teuler, fn)(t64(U)))


def test_eigen_matrices_match_jax_and_round_trip():
    U = random_states(6, strong=True)
    W = random_states(7)
    ja = jeuler.eigen_matrices(jnp.asarray(U))
    tb = teuler.eigen_matrices(t64(U))
    for a, b in zip(ja, tb):
        close(a, b)
    Rx, Lx, Ry, Ly = tb
    Wt = t64(W)
    for R, L in ((Rx, Lx), (Ry, Ly)):
        Wc = teuler.to_characteristic(L, Wt)
        close(jeuler.to_characteristic(jnp.asarray(np.asarray(L)),
                                       jnp.asarray(W)), Wc)
        close(W, teuler.to_conserved(R, Wc))


@pytest.mark.parametrize("kind", ("INFLOW", "OUTFLOW", "SLIP", "FARFIELD",
                                  "PRESSURE"))
@pytest.mark.parametrize("normal", NORMALS)
def test_compute_wminus_matches_jax(kind, normal):
    code = getattr(teuler, "BC_" + kind)
    assert code == getattr(jeuler, "BC_" + kind)
    Wp = random_states(8)
    bv = random_states(9)
    nx, ny = normal
    a = jeuler.compute_wminus(code, nx, ny, jnp.asarray(Wp), jnp.asarray(bv))
    b = teuler.compute_wminus(code, nx, ny, t64(Wp), t64(bv))
    close(a, b)


def test_unported_kinds_and_fluxes_raise():
    # every boundary kind is ported: the pressure ghost keeps the trace's
    # momentum and density and takes its energy from the prescribed
    # pressure in the energy slot (test_compute_wminus_matches_jax)
    W = t64(random_states(10, n=4))
    bv = t64(random_states(11, n=4))
    g = teuler.compute_wminus(teuler.BC_PRESSURE, 1.0, 0.0, W, bv)
    assert torch.equal(g[:3], W[:3])
    close(teuler.pressure(g), bv[teuler.ENE])
    assert tfluxes.get_flux("hllc") is tfluxes.hllc
    assert tfluxes.get_flux("lxf") is tfluxes.lxf
    # the other four fluxes are ported (tests/test_torch_fluxes.py)
    for name in ("roe", "sw", "kfvs", "kep"):
        assert name in jfluxes.FLUX_FUNCTIONS
        assert tfluxes.get_flux(name) is tfluxes.FLUX_FUNCTIONS[name]
    with pytest.raises(ValueError):
        tfluxes.get_flux("nope")
