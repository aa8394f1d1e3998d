r"""Layer-potential coefficients in the harmonic basis.

On a sphere of radius rho the single/double layer operators are diagonal
per harmonic degree n:

    slc_n(rho) = i k^{d-2} rho^{d-1} j_n(k rho)
    dlc_n(rho) = i k^{d-1} rho^{d-1} j_n'(k rho)
    blc_n(rho, eta) = dlc_n(rho) - i eta slc_n(rho)     (combined field)

as in biem_helmholtz_sphere_tpu.biem._layer.  Real or complex k; complex
outputs.  `potential_coef` is the same coefficient elementwise in the
degree n, with the outgoing factor h_n(k |x|) on request.
"""

import torch

from ..harmonics._index import basis
from ..ops.kernels import as_tensors
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


def _gather_order(tab, n):
    """Elementwise tab[..., n[...]] with n broadcast to tab's batch shape."""
    idx = n.to(device=tab.device, dtype=torch.long).expand(tab.shape[:-1])
    return torch.gather(tab, -1, idx[..., None])[..., 0]


def potential_coef(n, d, k, y_abs, x_abs=None, derivative="S", limit=True,
                   for_func="solution"):
    """The layer coefficient elementwise in (n, k, y_abs, x_abs): complex.

    n: integer degrees; d: the dimension; k real or complex; y_abs the
    sphere's radius.  derivative "S" -> slc_n(y_abs), "D" -> dlc_n(y_abs);
    for_func "solution" -> the bare coefficient, "harmonics" -> times the
    outgoing h_n(k x_abs).  `limit` is accepted as in the JAX package.  It
    runs on the device of the tensor arguments (the card when none is a
    tensor); the order tables are K5 launches (unscaled) on CUDA tensors.
    """
    n, k, y_abs, x_abs = as_tensors(n, k, y_abs, x_abs)
    d = int(d)
    shape = torch.broadcast_shapes(n.shape, k.shape, y_abs.shape)
    k = k.expand(shape)
    y_abs = y_abs.expand(shape)
    n_end = int(n.max()) + 1
    j, jp, _, _ = spherical_jh_all(d, n_end, k * y_abs)
    pref = 1j * k ** (d - 2) * y_abs ** (d - 1)
    if derivative == "S":
        coef = pref * _gather_order(j, n)
    elif derivative == "D":
        coef = pref * k * _gather_order(jp, n)
    else:
        raise ValueError(f"derivative must be 'S' or 'D', got {derivative!r}")
    if for_func == "harmonics":
        if x_abs is None:
            raise ValueError("x_abs required for for_func='harmonics'")
        x_abs = x_abs.expand(shape)
        _, _, hx, _ = spherical_jh_all(d, n_end, k * x_abs)
        coef = coef * _gather_order(hx, n)
    elif for_func != "solution":
        raise ValueError(
            f"for_func must be 'solution' or 'harmonics', got {for_func!r}"
        )
    return coef
