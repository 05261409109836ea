"""2-D compressible Euler physics as plain torch functions.

The torch counterparts of dflo_tpu/physics/euler.py.  All functions operate on
conserved-state tensors ``U[4, ...]`` with the component axis leading and
arbitrary trailing batch dims; everything is branchless (``torch.where``
selects), so the same code runs on any device and dtype.

Component order matches the reference (src/equation.h:26-28):
momentum first, then density, then energy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# component indices (dim = 2)
MX, MY, RHO, ENE = 0, 1, 2, 3
N_COMP = 4
GAMMA = 1.4  # src/equation.cc:33

#: positivity floor for the sqrt arguments of wave speeds (see
#: dflo_tpu/physics/euler.FLOOR): keeps f32 Mach-10 shocks NaN-free while
#: leaving every finite-state result bit-identical
FLOOR = 1.0e-13


def _pos(x):
    """max(x, FLOOR) for quantities that are positive up to roundoff."""
    return torch.clamp(x, min=FLOOR)


def kinetic_energy(U):
    """0.5*|m|^2/rho  (src/equation.h:67-79)."""
    return 0.5 * (U[MX] * U[MX] + U[MY] * U[MY]) / U[RHO]


def pressure(U):
    """(gamma-1)(E - ke)  (src/equation.h:84-92)."""
    return (GAMMA - 1.0) * (U[ENE] - kinetic_energy(U))


def sound_speed(U):
    return torch.sqrt(GAMMA * _pos(pressure(U)) / _pos(U[RHO]))


def max_eigenvalue(U):
    """|v| + c  (src/equation.h:97-114)."""
    v = torch.sqrt(U[MX] * U[MX] + U[MY] * U[MY]) / U[RHO]
    return v + sound_speed(U)


def max_eigenvalue_normal(U, nx, ny):
    """|v.n| + c  (src/equation.h:119-137)."""
    vn = (U[MX] * nx + U[MY] * ny) / U[RHO]
    return torch.abs(vn) + sound_speed(U)


def entropy_var(U):
    """Entropy variables V(U)  (src/equation.h:1039-1058)."""
    p = pressure(U)
    T = p / U[RHO]
    u = U[MX] / U[RHO]
    v = U[MY] / U[RHO]
    u2 = u * u + v * v
    Vr = torch.log(U[RHO] / T ** (1.0 / (GAMMA - 1.0))) - 0.5 * u2 / T
    return torch.stack([u / T, v / T, Vr, -1.0 / T])


def flux_x(U):
    """Cartesian x-flux column F(U)  (src/equation.h:158-193)."""
    p = pressure(U)
    u = U[MX] / U[RHO]
    return torch.stack([U[MX] * u + p, U[MY] * u, U[MX], (U[ENE] + p) * u])


def flux_y(U):
    p = pressure(U)
    v = U[MY] / U[RHO]
    return torch.stack([U[MX] * v, U[MY] * v + p, U[MY], (U[ENE] + p) * v])


# -----------------------------------------------------------------------------
# Characteristic algebra (src/equation.h:225-306), in the internal ordering
# (rho, mx, my, E); to_characteristic/to_conserved reorder from/to the
# conserved layout exactly as the reference.
# -----------------------------------------------------------------------------

def eigen_matrices(U):
    """Left/right eigenvector matrices along x and y from state U[4, ...].

    Returns (Rx, Lx, Ry, Ly), each [4, 4, ...] in the (rho, mx, my, E)
    internal ordering of src/equation.h:225-265.
    """
    g1 = GAMMA - 1.0
    rho = U[RHO]
    u = U[MX] / rho
    v = U[MY] / rho
    q2 = u * u + v * v
    p = g1 * (U[ENE] - 0.5 * rho * q2)
    c2 = GAMMA * _pos(p) / _pos(rho)
    c = torch.sqrt(c2)
    # divisions by a constant are written as products with its reciprocal
    # (and 1/c2 once): csrc/euler.cuh `eigen` evaluates the same operations
    inv_c2 = torch.reciprocal(c2)
    beta = 0.5 * inv_c2
    phi2 = 0.5 * g1 * q2
    h = c2 * (1.0 / g1) + 0.5 * q2
    zero = torch.zeros_like(rho)
    one = torch.ones_like(rho)

    def M(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rx = M([[one, zero, one, one],
            [u, zero, u + c, u - c],
            [v, -one, v, v],
            [0.5 * q2, -v, h + c * u, h - c * u]])
    Ry = M([[one, zero, one, one],
            [u, one, u, u],
            [v, zero, v + c, v - c],
            [0.5 * q2, u, h + c * v, h - c * v]])
    Lx = M([[1 - phi2 / c2, g1 * u / c2, g1 * v / c2, -g1 * inv_c2],
            [v, zero, -one, zero],
            [beta * (phi2 - c * u), beta * (c - g1 * u), -beta * g1 * v,
             beta * g1],
            [beta * (phi2 + c * u), -beta * (c + g1 * u), -beta * g1 * v,
             beta * g1]])
    Ly = M([[1 - phi2 / c2, g1 * u / c2, g1 * v / c2, -g1 * inv_c2],
            [-u, one, zero, zero],
            [beta * (phi2 - c * v), -beta * g1 * u, beta * (c - g1 * v),
             beta * g1],
            [beta * (phi2 + c * v), -beta * g1 * u, -beta * (c + g1 * v),
             beta * g1]])
    return Rx, Lx, Ry, Ly


def eigen_matrices_dir(U, kx, ky):
    """Eigenvector matrices for the direction k = (kx, ky): the 2-argument
    compute_eigen_matrix of src_mpi/equation.h:300-331 (dflo_tpu/physics/
    euler.py:148).  Returns (R, L) in the internal (rho, mx, my, E)
    ordering; kx, ky broadcast against the state's trailing dims."""
    g1 = GAMMA - 1.0
    rho = U[RHO]
    u = U[MX] / rho
    v = U[MY] / rho
    q2 = u * u + v * v
    p = g1 * (U[ENE] - 0.5 * rho * q2)
    c2 = GAMMA * _pos(p) / _pos(rho)
    c = torch.sqrt(c2)
    beta = 0.5 / c2
    phi2 = 0.5 * g1 * q2
    h = c2 / g1 + 0.5 * q2
    uk = u * kx + v * ky
    one = torch.ones_like(rho)
    zero = torch.zeros_like(rho)

    def M(rows):
        return torch.stack([torch.stack([torch.broadcast_to(e, rho.shape)
                                         for e in r]) for r in rows])

    R = M([[one, zero, one, one],
           [u, ky * one, u + kx * c, u - kx * c],
           [v, -kx * one, v + ky * c, v - ky * c],
           [0.5 * q2, ky * u - kx * v, h + c * uk, h - c * uk]])
    L = M([[1 - phi2 / c2, g1 * u / c2, g1 * v / c2, -g1 / c2 * one],
           [-(ky * u - kx * v), ky * one, -kx * one, zero],
           [beta * (phi2 - c * uk), beta * (kx * c - g1 * u),
            beta * (ky * c - g1 * v), beta * g1 * one],
           [beta * (phi2 + c * uk), -beta * (kx * c + g1 * u),
            -beta * (ky * c + g1 * v), beta * g1 * one]])
    return R, L


def streamline_eigen_matrices(U):
    """(R, L) along the local velocity direction (src_mpi/equation.h:
    315-317, theta = atan2(v, u)); a stagnant cell takes the x-direction
    (atan2(0, 0) = 0, as in the reference)."""
    theta = torch.atan2(U[MY], U[MX])
    return eigen_matrices_dir(U, torch.cos(theta), torch.sin(theta))


def _reorder_to_internal(W):
    """(mx, my, rho, E) -> (rho, mx, my, E)  (src/equation.h:276-279)."""
    return torch.stack([W[RHO], W[MX], W[MY], W[ENE]])


def _reorder_to_conserved(V):
    return torch.stack([V[1], V[2], V[0], V[3]])


def _mat4(A, V):
    """A @ V per cell, each row summed in column order (as csrc/euler.cuh)."""
    return torch.stack([A[i, 0] * V[0] + A[i, 1] * V[1] + A[i, 2] * V[2]
                        + A[i, 3] * V[3] for i in range(4)])


def to_characteristic(L, W):
    """W_char = L @ reorder(W); L is [4, 4, ...], W is [4, ...]."""
    return _mat4(L, _reorder_to_internal(W))


def to_conserved(R, Wc):
    """Inverse transform (src/equation.h:290-306)."""
    return _reorder_to_conserved(_mat4(R, Wc))


# -----------------------------------------------------------------------------
# Boundary conditions (src/equation.h:862-1033)
# -----------------------------------------------------------------------------

# BoundaryKind codes, equal to dflo_tpu.physics.euler's
BC_INFLOW, BC_OUTFLOW, BC_SLIP, BC_PRESSURE, BC_FARFIELD, BC_PERIODIC, BC_NONE = (
    0, 1, 2, 3, 4, 5, -1)

#: the kinds a side may take (periodic is topological: the mesh pairs it)
SUPPORTED_BC = (BC_INFLOW, BC_OUTFLOW, BC_SLIP, BC_PRESSURE, BC_FARFIELD,
                BC_PERIODIC)


def mirror_x(U):
    """Slip-wall ghost for an x-normal face: reflect the normal momentum."""
    return torch.stack([-U[MX], U[MY], U[RHO], U[ENE]])


def mirror_y(U):
    return torch.stack([U[MX], -U[MY], U[RHO], U[ENE]])


def wall_fix(FL, FR, AL, AR, mL, mR, mirror):
    """Slip-wall mirror operands at the fluid|solid faces of a masked domain
    (dflo_tpu/solver/spatial.py:517-523, pallas_kernels.py:478-487): where
    the left cell is solid and the right one fluid, the left trace and
    average become the mirror of the right ones, and the other way round.
    mL, mR: bool fluid flags of the left and right cells, broadcast over
    the trailing axes of the [4, nq, ...] operands."""
    wL = (~mL & mR)[None, None]                 # solid | fluid
    wR = (mL & ~mR)[None, None]                 # fluid | solid
    return (torch.where(wL, mirror(FR), FL), torch.where(wR, mirror(FL), FR),
            torch.where(wL, mirror(AR), AL), torch.where(wR, mirror(AL), AR))


def compute_wminus(kind: int, nx: float, ny: float, Wplus, bvals):
    """Ghost state from the inside trace + BC data (src/equation.h:939-1033).

    kind  : one BC_* code (a segmented side calls this once per segment,
            solver/spatial.segment_ghost)
    nx,ny : outward unit normal components (floats, or tensors that
            broadcast against the trace on a curvilinear side)
    Wplus : [4, ...] inside trace
    bvals : [4, ...] boundary expression values (the pressure kind reads
            its prescribed pressure from the energy slot, src/equation.h:992)
    """
    if kind in (BC_INFLOW, BC_FARFIELD):
        return bvals
    if kind == BC_PRESSURE:
        # momentum and density from the trace, the energy from the
        # prescribed pressure (dflo_tpu/physics/euler.py:237-247)
        return torch.stack([Wplus[MX], Wplus[MY], Wplus[RHO],
                            bvals[ENE] / (GAMMA - 1.0)
                            + kinetic_energy(Wplus)])
    if kind == BC_SLIP:
        vdotn = Wplus[MX] * nx + Wplus[MY] * ny
        return torch.stack([Wplus[MX] - 2.0 * vdotn * nx,
                            Wplus[MY] - 2.0 * vdotn * ny,
                            Wplus[RHO], Wplus[ENE]])
    # outflow, and any code the reference's where-chain does not name,
    # copies the trace
    return Wplus


def forcing_gravity(U, gvec=(0.0, -1.0)):
    """Gravity source (g1*rho, g2*rho, 0, rho g.v)  (src/equation.h:829-850).

    The operation order is the reference's (dflo_tpu/physics/euler.py:268),
    a zero gx included, so that csrc/residual.cuh rounds alike."""
    gx, gy = gvec
    z = torch.zeros_like(U[RHO])
    fx = gx * U[RHO]
    fy = gy * U[RHO]
    fe = gx * U[MX] + gy * U[MY]
    return torch.stack([fx, fy, z, fe])


def forcing_external(U, fx, fy):
    """General body force f(x, y, t): (rho fx, rho fy, 0, f.m)
    (src_mpi/equation.h:1186-1202)."""
    z = torch.zeros_like(U[RHO])
    return torch.stack([U[RHO] * fx, U[RHO] * fy, z,
                        U[MX] * fx + U[MY] * fy])


def well_balanced_source(W, fac, dEx, dEy):
    """[Sx, Sy, 0, SE] of a well-balanced gravity source at the nodes:
    S = fac grad_h E, SE = (m . S) / rho (src_gll/assemble_explicit.cc:
    30-230; fac = p / E of the equilibrium profile E)."""
    Sx = fac * dEx
    Sy = fac * dEy
    SE = (W[MX] * Sx + W[MY] * Sy) / W[RHO]
    return torch.stack([Sx, Sy, torch.zeros_like(Sx), SE])


@dataclasses.dataclass(frozen=True)
class GravitySource:
    """The constant body force g = (gx, gy) per unit mass (the CLI's
    `gravity`, src/equation.h:829-850), callable as the reference's
    source(x, y, t, W) -> [4, ...]; the fused residual applies it in its
    kernel from the two scalars."""
    gx: float
    gy: float

    def __call__(self, x, y, t, W):
        return forcing_gravity(W, (self.gx, self.gy))


@dataclasses.dataclass(frozen=True)
class ExternalForce:
    """A body force per unit mass f(x, y, t) -> (fx, fy) (the CLI's `f_0`,
    `f_1` expressions, src_mpi/equation.h:1186-1202), callable as the
    reference's source(x, y, t, W); the fused residual evaluates f on the
    volume quadrature points at each call's t and its kernel applies
    forcing_external."""
    f: Callable

    def __call__(self, x, y, t, W):
        fx, fy = self.f(x, y, t)
        return forcing_external(W, fx, fy)
