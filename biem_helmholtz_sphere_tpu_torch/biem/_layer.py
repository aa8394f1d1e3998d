r"""Layer-potential coefficients in the harmonic basis.

On a sphere of radius rho the single/double layer operators are diagonal
per harmonic degree n:

    slc_n(rho) = i k^{d-2} rho^{d-1} j_n(k rho)
    dlc_n(rho) = i k^{d-1} rho^{d-1} j_n'(k rho)
    blc_n(rho, eta) = dlc_n(rho) - i eta slc_n(rho)     (combined field)

as in biem_helmholtz_sphere_tpu.biem._layer.  Real or complex k; complex
outputs.
"""

import torch

from ..harmonics._index import basis
from ..special._family import spherical_jh_all


def slc_dlc(c, n_end, k, rho):
    """(slc, dlc) per flat harmonic: complex [..., H] (k, rho broadcast)."""
    d = c.c_ndim
    n_idx = torch.as_tensor(basis(c, n_end).n_root, device=rho.device, dtype=torch.long)
    j, jp, _, _ = spherical_jh_all(d, n_end, k * rho)
    pref = (1j * k ** (d - 2) * rho ** (d - 1))[..., None]
    slc = pref * j.index_select(-1, n_idx)
    dlc = pref * k[..., None] * jp.index_select(-1, n_idx)
    return slc, dlc


def blc(c, n_end, k, rho, eta):
    """Combined-field coefficient dlc - i eta slc per flat harmonic [..., H]."""
    s, dl = slc_dlc(c, n_end, k, rho)
    return dl - s * (1j * eta)[..., None]
