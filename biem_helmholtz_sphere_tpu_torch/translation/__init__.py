"""Addition-theorem translation: the rotation + scale-compensated coaxial
factors of the factored (S|R) operator."""

from ._rotation import rotation_blocks, rotation_matrix
from ._scaled import coaxial_scaled

__all__ = ["rotation_blocks", "rotation_matrix", "coaxial_scaled"]
