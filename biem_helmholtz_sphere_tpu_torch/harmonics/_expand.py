"""Projection of a function on S^{d-1} onto the flat harmonic basis.

f_h = integral f(y) conj(Y_h(y)) dS(y), by the tree's product quadrature
(`sphere_quadrature`), as biem_helmholtz_sphere_tpu.harmonics._expand:
one [rest, Q] x [Q, H] product after evaluating the integrand at the
quadrature nodes.
"""

from functools import lru_cache

import numpy as np
import torch

from ..coords import to_cartesian
from ..ops.kernels import default_device
from ._eval import harmonics
from ._quad import sphere_quadrature


@lru_cache(maxsize=16)
def _quad_tables(c, n_end, deg):
    """Host float64 tables: (nodes {nid: angles [Q]}, unit points [d, Q],
    conj(Y) w [Q, H] complex128)."""
    sph, w = sphere_quadrature(c, deg)
    sph_t = {key: torch.as_tensor(v, dtype=torch.float64) for key, v in sph.items()}
    wy = harmonics(c, sph_t, n_end).conj().resolve_conj() * torch.as_tensor(w)[:, None]
    return sph, to_cartesian(c, sph_t, include_r=False), wy


@lru_cache(maxsize=16)
def _quad_harmonics(c, n_end, deg, dtype, device):
    """(unit points [d, Q] in the real dtype, conj(Y) w [Q, H] complex) on
    device, cached per (tree, n_end, deg, dtype, device)."""
    _, xhat, wy = _quad_tables(c, n_end, deg)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return xhat.to(dtype=dtype, device=device), wy.to(dtype=cdt, device=device)


def expand(c, f, n_end, deg=None):
    """Project callable f onto harmonics of degree < n_end: [..., num].

    f receives {nid: angles [Q]} (host numpy arrays: the quadrature is
    static) and returns an array whose FIRST axis is Q; the remaining axes
    are kept in front of the harmonic axis.  `deg` sets the quadrature's
    exactness (default 2 (n_end - 1) + 1).  The product runs on the device
    of f's output when it is a tensor, else on the card.
    """
    if deg is None:
        deg = 2 * (n_end - 1) + 1
    sph, _, _ = _quad_tables(c, n_end, deg)
    fx = f(sph)
    if not isinstance(fx, torch.Tensor):
        fx = torch.as_tensor(np.asarray(fx), device=default_device())
    rdt = torch.float64 if fx.dtype in (torch.float64, torch.complex128) else torch.float32
    _, wy = _quad_harmonics(c, n_end, deg, rdt, fx.device)
    q = fx.shape[0]
    out = torch.matmul(fx.reshape(q, -1).T.to(wy.dtype), wy)
    return out.reshape(fx.shape[1:] + (wy.shape[-1],))
