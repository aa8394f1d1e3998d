"""Polyspherical coordinate systems."""

from ._transform import from_cartesian, to_cartesian
from ._tree import (
    Node,
    SphericalCoordinates,
    create_from_branching_types,
    create_hopf,
    create_random,
    create_standard,
    create_standard_prime,
)

__all__ = [
    "Node",
    "SphericalCoordinates",
    "create_from_branching_types",
    "create_standard",
    "create_standard_prime",
    "create_hopf",
    "create_random",
    "to_cartesian",
    "from_cartesian",
]
