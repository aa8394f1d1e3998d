"""Gauss-Jacobi quadrature nodes/weights (host-side numpy, float64).

Golub-Welsch eigenvalue method, as in
biem_helmholtz_sphere_tpu.special._quad.
"""

import numpy as np

from ._jacobi import jacobi_mu0, jacobi_recurrence


def gauss_jacobi(q, alpha, beta):
    """q-point Gauss-Jacobi rule for weight (1-x)^alpha (1+x)^beta on [-1,1].

    Exact for polynomials of degree <= 2q - 1.  Returns (x, w) float64.
    """
    if q < 1:
        raise ValueError("q must be >= 1")
    a, b = jacobi_recurrence(q, alpha, beta)
    t = np.diag(a[:q]) + np.diag(b[1:q], 1) + np.diag(b[1:q], -1)
    x, v = np.linalg.eigh(t)
    w = jacobi_mu0(alpha, beta) * v[0, :] ** 2
    return x, w


def uniform_circle(q):
    """q-point uniform rule on [0, 2pi): exact for e^{i m phi}, |m| < q."""
    phi = 2.0 * np.pi * np.arange(q) / q
    w = np.full(q, 2.0 * np.pi / q)
    return phi, w
