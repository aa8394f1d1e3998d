"""BIEM: the factored matrix-free solve and the field evaluation."""

from ._core import BIEMResultCalculator, biem
from ._eval import biem_u
from ._layer import blc, slc_dlc
from ._types import BIEMKwargs, BIEMResultCalculatorProtocol, UinCallable
from ._waves import plane_wave

__all__ = [
    "biem",
    "biem_u",
    "BIEMResultCalculator",
    "BIEMResultCalculatorProtocol",
    "BIEMKwargs",
    "UinCallable",
    "plane_wave",
    "slc_dlc",
    "blc",
]
