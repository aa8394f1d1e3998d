"""Single-order spherical Hankel/Bessel evaluation (point sources).

As biem_helmholtz_sphere_tpu.special._shn1: one order n of the
d-dimensional family, through `spherical_jh_all` (K5's unscaled mode on
CUDA tensors, its plain version on CPU tensors).
"""

import torch

from ..ops.kernels import default_device
from ._family import spherical_jh_all


def _z(z):
    return z if isinstance(z, torch.Tensor) else torch.as_tensor(z, device=default_device())


def shn1(n, d, z, derivative=False):
    """d-dimensional spherical Hankel h^{(1)}_n(z) (or its derivative):
    complex, z's shape."""
    n = int(n)
    _, _, h, hp = spherical_jh_all(int(d), n + 1, _z(z))
    return hp[..., n] if derivative else h[..., n]


def sjn(n, d, z, derivative=False):
    """d-dimensional spherical Bessel j_n(z) (or its derivative): complex,
    z's shape."""
    n = int(n)
    j, jp, _, _ = spherical_jh_all(int(d), n + 1, _z(z))
    return jp[..., n] if derivative else j[..., n]
