"""Hyperspherical harmonics over branching trees."""

from ._eval import harmonics
from ._expand import expand
from ._index import (
    HarmonicBasis,
    assume_n_end_from_num,
    basis,
    harm_n_ndim,
    harm_n_ndim_le,
)
from ._quad import sphere_quadrature

__all__ = [
    "HarmonicBasis",
    "basis",
    "harmonics",
    "expand",
    "harm_n_ndim",
    "harm_n_ndim_le",
    "assume_n_end_from_num",
    "sphere_quadrature",
]
