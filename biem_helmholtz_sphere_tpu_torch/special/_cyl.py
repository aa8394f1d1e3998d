"""Cylinder Bessel seeds J0, J1, H^{(1)}_0, H^{(1)}_1 at complex z.

The seeds of the base-2 (even d) family of `_family.py`: with d = 2 + 2m,
j_n^{(d)}(z) = z^{-m} j^{(2)}_{n+m}(z) and j^{(2)}_n = sqrt(pi/2) J_n.
As biem_helmholtz_sphere_tpu.special._cyl: the ascending power series
for |z| <= 14 (DLMF 10.2.2, 10.8.1) and the Hankel asymptotic expansions
above (DLMF 10.17.5-6), with the same coefficients, the same Horner order
and the same seam.  Valid for Re z >= 0 with moderate Im z (z = k r with
r > 0 and Re k >= 0).

Near the seam the series' terms reach ~e^14 / sqrt(2 pi 14) ~ 1e5 before
they cancel, so about five digits are lost there: float64 agrees with
scipy.special to ~6e-11 at real |z| in [10, 14], while the same series in
float32 arithmetic is off by up to 4.5e-3 there (and by 0.05 on the
normalised h mantissas of d = 2 at z = 13.9 + 1j; tools/torch_cyl_seam.py).  So the seeds are evaluated in
float64 for either dtype and rounded to the input's at the end (the JAX
package's float32 seeds take float64 too on a CPU with x64, its
coefficients being float64 numpy scalars); they cost one evaluation per z.

K5's base-2 mode (`csrc/spherical_jh.cu`) evaluates the same series and
expansions on the card, in float64 too; `cyl_jh01` here is plain torch on
any device.
"""

import numpy as np
import torch

_EULER_GAMMA = 0.5772156649015328606
_CUT = 14.0
_N_SERIES = 42
_N_ASYM = 24


def _log_factorial(k):
    return float(np.sum(np.log(np.arange(1, k + 1)))) if k > 0 else 0.0


def _series_j01_coefs():
    """(c0, c1) per Horner step k = N-1 .. 0: (-1)^k / k!^2 and
    (-1)^k / (k! (k+1)!), in log space so they stay finite."""
    out = []
    for k in range(_N_SERIES - 1, -1, -1):
        lf_k = _log_factorial(k)
        out.append(((-1.0) ** k * np.exp(-2.0 * lf_k),
                    (-1.0) ** k * np.exp(-2.0 * lf_k - np.log(k + 1.0))))
    return out


def _series_y0_coefs():
    """Horner coefficients of Y0's series, highest power first."""
    coef0, hk = [], 0.0
    for k in range(1, _N_SERIES):
        hk += 1.0 / k
        coef0.append((-1.0) ** (k + 1) * hk * np.exp(-2.0 * _log_factorial(k)))
    return coef0[::-1]


def _series_y1_coefs():
    """Horner coefficients of Y1's series, highest power first."""
    coef1, psi1 = [], -_EULER_GAMMA
    for k in range(_N_SERIES):
        psi2 = psi1 + 1.0 / (k + 1.0)
        lf_k = _log_factorial(k)
        coef1.append((-1.0) ** k * (psi1 + psi2) * np.exp(-lf_k - (lf_k + np.log(k + 1.0))))
        psi1 = psi2
    return coef1[::-1]


def _asym_coefs(nu, sign):
    """(sign i)^k a_k(nu), k = N-1 .. 1: the Hankel expansion's terms in
    Horner order."""
    mu = 4.0 * nu * nu
    coefs, a = [], 1.0
    for k in range(1, _N_ASYM):
        a *= (mu - (2.0 * k - 1.0) ** 2) / (k * 8.0)
        coefs.append(complex((sign * 1j) ** k) * a)
    return coefs[::-1]


_J01 = _series_j01_coefs()
_Y0 = _series_y0_coefs()
_Y1 = _series_y1_coefs()
_ASYM = {(nu, sign): _asym_coefs(nu, sign) for nu in (0.0, 1.0) for sign in (1, -1)}


def cyl_table():
    """The coefficients above as K5 reads them: float64 [351], J0's and
    J1's series, Y0's, Y1's, then the complex terms (re, im) of the Hankel
    expansions for (nu, sign) = (0, +), (1, +), (0, -), (1, -), each block
    in Horner order (csrc/spherical_jh.cu, kCyl*)."""
    asym = [_ASYM[key] for key in ((0.0, 1), (1.0, 1), (0.0, -1), (1.0, -1))]
    return np.concatenate([
        [c0 for c0, _ in _J01], [c1 for _, c1 in _J01], _Y0, _Y1,
        np.stack([np.real(asym), np.imag(asym)], axis=-1).ravel(),
    ]).astype(np.float64)


def _series_j01(z):
    """J0, J1 by the ascending series sum_k (-1)^k (z/2)^(2k+n) / (k! (k+n)!)."""
    q = (z / 2.0) ** 2
    j0 = torch.zeros_like(z)
    j1 = torch.zeros_like(z)
    for c0, c1 in _J01:
        j0 = j0 * q + c0
        j1 = j1 * q + c1
    return j0, j1 * (z / 2.0)


def _series_y01(z, j0, j1):
    """Y0, Y1 by the logarithmic ascending series (DLMF 10.8.1)."""
    q = (z / 2.0) ** 2
    lg = torch.log(z / 2.0) + _EULER_GAMMA
    s0 = torch.zeros_like(z)
    for c in _Y0:
        s0 = (s0 + c) * q
    y0 = (lg * j0 + s0) * (2.0 / np.pi)
    s1 = torch.zeros_like(z)
    for c in _Y1:
        s1 = s1 * q + c
    # Y1 (DLMF 10.8.1) has plain ln(z/2); gamma sits inside the psi terms
    y1 = ((lg - _EULER_GAMMA) * j1 * (2.0 / np.pi) - (2.0 / np.pi) / z
          - s1 * (z / 2.0) * (1.0 / np.pi))
    return y0, y1


def _asym_h(nu, z, sign):
    """H^{(1)}_nu (sign=+1) or H^{(2)}_nu (sign=-1), DLMF 10.17.5-6."""
    inv = 1.0 / z
    s = torch.zeros_like(z)
    for c in _ASYM[(nu, sign)]:
        s = (s + c) * inv
    s = s + 1.0
    omega = z - (0.5 * nu + 0.25) * np.pi
    pref = torch.sqrt((2.0 / np.pi) / z)
    return pref * torch.exp(omega * (sign * 1j)) * s


def cyl_jh01(z):
    """(J0, J1, H^{(1)}_0, H^{(1)}_1) at z (real or complex tensor),
    elementwise, complex of z's precision, evaluated in float64.  The
    series below |z| = 14, the Hankel asymptotics above.

    >>> import torch
    >>> j0, j1, h0, h1 = cyl_jh01(torch.tensor([1.0, 20.0], dtype=torch.float64))
    >>> print(f"{j0[0].real:.9f} {j1[1].real:.9f} {h0[0].imag:.9f}")  # J0(1), J1(20), Y0(1)
    0.765197687 0.066833124 0.088256964
    """
    z = torch.as_tensor(z)
    cdt = (torch.complex128 if z.dtype in (torch.float64, torch.complex128)
           else torch.complex64)
    z = z.to(torch.complex128)
    big = z.abs() > _CUT
    z_small = torch.where(big, torch.ones_like(z), z)
    z_big = torch.where(big, z, torch.full_like(z, 2.0 * _CUT))

    j0_s, j1_s = _series_j01(z_small)
    y0_s, y1_s = _series_y01(z_small, j0_s, j1_s)
    h0_s = j0_s + y0_s * 1j
    h1_s = j1_s + y1_s * 1j

    h1a_0 = _asym_h(0.0, z_big, +1)
    h1a_1 = _asym_h(1.0, z_big, +1)
    j0_a = (h1a_0 + _asym_h(0.0, z_big, -1)) * 0.5
    j1_a = (h1a_1 + _asym_h(1.0, z_big, -1)) * 0.5
    return tuple(torch.where(big, a, s).to(cdt) for a, s in
                 ((j0_a, j0_s), (j1_a, j1_s), (h1a_0, h0_s), (h1a_1, h1_s)))
