"""Special functions: spherical Bessel/Hankel families, orthonormal Jacobi
recurrences and Gauss-Jacobi rules."""

from ._cyl import cyl_jh01
from ._family import (
    family_jh,
    spherical_h_scaled,
    spherical_jh_all,
    spherical_jh_scaled,
)
from ._jacobi import (
    jacobi_mu0,
    jacobi_recurrence,
    orthonormal_jacobi_all,
    orthonormal_jacobi_table,
)
from ._quad import gauss_jacobi, uniform_circle
from ._shn1 import shn1, sjn

__all__ = [
    "cyl_jh01",
    "family_jh",
    "spherical_jh_all",
    "spherical_jh_scaled",
    "spherical_h_scaled",
    "shn1",
    "sjn",
    "jacobi_mu0",
    "jacobi_recurrence",
    "orthonormal_jacobi_table",
    "orthonormal_jacobi_all",
    "gauss_jacobi",
    "uniform_circle",
]
