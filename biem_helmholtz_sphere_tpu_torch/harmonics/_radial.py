"""Radial factors per flat harmonic: j_n(kr), h^{(1)}_n(kr), derivatives,
as biem_helmholtz_sphere_tpu.harmonics._radial."""

import torch

from ..ops.kernels import as_tensors
from ..special._family import spherical_jh_all
from ._index import basis


def regular_singular_component(c, r, n_end, k, type="regular", derivative=False):
    """Complex [..., num] radial factor per flat harmonic at radius r,
    wavenumber k (real or complex; r and k broadcast together, the
    harmonic axis is appended last).

    type="regular" -> j_n (or j_n'); type="singular" -> h^{(1)}_n (or
    h_n').  It runs on the device of r and k (the card when neither is a
    tensor); the order table is one K5 launch (unscaled) on CUDA tensors.
    """
    if type not in ("regular", "singular"):
        raise ValueError(f"invalid type {type!r}")
    r, k = as_tensors(r, k)
    z = k * r
    j, jp, h, hp = spherical_jh_all(c.c_ndim, n_end, z)
    if type == "regular":
        tab = jp if derivative else j
    else:
        tab = hp if derivative else h
    return tab.index_select(-1, torch.as_tensor(basis(c, n_end).n_root, dtype=torch.long,
                                                device=z.device))
