"""Addition-theorem translation: (S|R) / (R|R) by rotation + coaxial for
'b'-rooted trees (the coaxial factor by the band sum or, on "ba"/"bpa",
by the Gumerov-Duraiswami recurrences) and by the band scan for any tree
in d >= 3, unscaled and scale-compensated, and the factored route's
rotation and packed coaxial factors."""

from ._gumerov import gd_coaxial, sr_gumerov
from ._ops import translation_matrix
from ._rotation import coaxial_sr, rotation_blocks, rotation_matrix, sr_rotation
from ._scaled import coaxial_scaled, sr_scaled

__all__ = [
    "translation_matrix",
    "gd_coaxial",
    "sr_gumerov",
    "sr_rotation",
    "sr_scaled",
    "coaxial_sr",
    "coaxial_scaled",
    "rotation_blocks",
    "rotation_matrix",
]
