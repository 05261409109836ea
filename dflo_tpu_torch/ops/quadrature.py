"""1-D quadrature rules on the unit interval [0, 1].

A copy of dflo_tpu/ops/quadrature.py.  Setup-time constants are computed in
float64 numpy (independent of the solver's working dtype) and converted to the
working dtype by the solver.  The reference uses deal.II QGauss /
QGaussLobatto on the unit cell (src/claw.cc:231, src/positivity.cc:44);
weights on [0,1] sum to 1.
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre points/weights on [0,1]. Exact for degree 2n-1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0)), (0.5 * w)


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre points/weights on [0,1] (n >= 2).

    Interior points are roots of P'_{n-1}; weights w_i = 2/(n(n-1) P_{n-1}(x)^2)
    on [-1,1], halved for [0,1]. Exact for degree 2n-3.
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # roots of derivative of Legendre polynomial P_{n-1}
        c = np.zeros(n)
        c[-1] = 1.0
        dleg = np.polynomial.legendre.Legendre(c).deriv()
        x = np.concatenate([[-1.0], np.sort(dleg.roots()), [1.0]])
    Pn1 = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    return (0.5 * (x + 1.0)), (0.5 * w)
