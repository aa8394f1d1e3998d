"""BIEM: assembly, the solver routes, incident waves and the field evaluation."""

from ._core import BIEMResultCalculator, biem
from ._eval import biem_u
from ._layer import blc, potential_coef, slc_dlc
from ._memory import max_memory, max_n_end
from ._types import BIEMKwargs, BIEMResultCalculatorProtocol, UinCallable
from ._waves import plane_wave, point_source

__all__ = [
    "biem",
    "biem_u",
    "BIEMResultCalculator",
    "BIEMResultCalculatorProtocol",
    "BIEMKwargs",
    "UinCallable",
    "plane_wave",
    "point_source",
    "max_memory",
    "max_n_end",
    "potential_coef",
    "slc_dlc",
    "blc",
]
