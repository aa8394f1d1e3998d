"""Polyspherical coordinate systems."""

from ._transform import from_cartesian, to_cartesian
from ._tree import Node, SphericalCoordinates, create_from_branching_types

__all__ = [
    "Node",
    "SphericalCoordinates",
    "create_from_branching_types",
    "to_cartesian",
    "from_cartesian",
]
