"""Orthonormal Jacobi polynomial recurrences.

The orthonormal family p~_n(x) for weight (1-x)^alpha (1+x)^beta on
[-1, 1] obeys

    x p~_n = b_{n+1} p~_{n+1} + a_n p~_n + b_n p~_{n-1}

so values stay O(1) at large degree.  The coefficients are host numpy
(float64); the evaluation is a torch loop over the degree.
"""

import numpy as np
import torch
from scipy.special import gammaln

from ..ops.kernels import as_tensors


def jacobi_mu0(alpha, beta):
    """mu_0 = integral of (1-x)^alpha (1+x)^beta over [-1, 1]."""
    return np.exp(
        (alpha + beta + 1.0) * np.log(2.0)
        + gammaln(alpha + 1.0)
        + gammaln(beta + 1.0)
        - gammaln(alpha + beta + 2.0)
    )


def jacobi_recurrence(n_max, alpha, beta):
    """Jacobi-matrix coefficients (a_n, b_n) for n = 0..n_max (numpy, host).

    a_n is the diagonal, b_n (n >= 1) the off-diagonal of the Jacobi matrix
    of the orthonormal family; b_0 = sqrt(mu_0).
    """
    n = np.arange(n_max + 1, dtype=np.float64)
    s = alpha + beta
    with np.errstate(invalid="ignore", divide="ignore"):
        a = (beta**2 - alpha**2) / ((2 * n + s) * (2 * n + s + 2))
    a[0] = (beta - alpha) / (s + 2.0)  # the n=0 formula is 0/0 when s=0
    b2 = np.empty(n_max + 1)
    b2[0] = jacobi_mu0(alpha, beta)
    nn = n[1:]
    b2[1:] = (
        4.0
        * nn
        * (nn + alpha)
        * (nn + beta)
        * (nn + s)
        / ((2 * nn + s) ** 2 * (2 * nn + s + 1) * (2 * nn + s - 1))
    )
    return a, np.sqrt(b2)


def orthonormal_jacobi_table(x, n_max, alphas, betas):
    """Table of orthonormal Jacobi values for several (alpha, beta) families.

    x: real tensor [...]; alphas/betas: length-F host floats.
    Returns [..., F, n_max+1] with entry [..., f, n] = p~_n^{(af, bf)}(x).
    """
    n_fam = len(alphas)
    a = np.zeros((n_fam, n_max + 1))
    b = np.zeros((n_fam, n_max + 1))
    for f in range(n_fam):
        a[f], b[f] = jacobi_recurrence(n_max, float(alphas[f]), float(betas[f]))
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    x_ = x[..., None]
    pn = torch.ones_like(x_) / b[:, 0]  # [..., F]
    pm = torch.zeros_like(pn)
    out = [pn]
    for n in range(n_max):
        pp = ((x_ - a[:, n]) * pn - b[:, n] * pm) / b[:, n + 1]
        pm, pn = pn, pp
        out.append(pp)
    return torch.stack(out, dim=-1)


def orthonormal_jacobi_all(x, n_max, alpha, beta):
    """One family of `orthonormal_jacobi_table`: [..., n_max+1] (x of an
    integer dtype is taken in float64); on x's device when it is a
    tensor, else on the card."""
    (x,) = as_tensors(x)
    if not x.is_floating_point():
        x = x.double()
    return orthonormal_jacobi_table(x, n_max, [alpha], [beta])[..., 0, :]
