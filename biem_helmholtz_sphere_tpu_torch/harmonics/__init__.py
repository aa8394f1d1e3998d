"""Hyperspherical harmonics over branching trees."""

from ._eval import Phase, harmonics
from ._expand import expand
from ._index import (
    HarmonicBasis,
    assume_n_end_from_num,
    basis,
    harm_n_ndim,
    harm_n_ndim_le,
    index_array_harmonics,
)
from ._quad import sphere_quadrature
from ._radial import regular_singular_component

__all__ = [
    "HarmonicBasis",
    "basis",
    "harmonics",
    "Phase",
    "expand",
    "harm_n_ndim",
    "harm_n_ndim_le",
    "index_array_harmonics",
    "assume_n_end_from_num",
    "sphere_quadrature",
    "regular_singular_component",
]
