"""biem-helmholtz-sphere-tpu, ported to PyTorch and hand-written CUDA kernels.

The PyTorch counterpart of `biem_helmholtz_sphere_tpu` (the JAX package,
kept as the reference): the same module layout and public names, native
torch complex dtypes, eager loops, and CUDA kernels for Hopper on the hot
stages.  It covers `biem` for every tree (2D, and any tree of 'b', 'bp'
and 'c' nodes in d >= 3), real or complex k, and a geometry shared by the batch
or varying along it (every route of the JAX package: diagonal, direct
LU, dense GMRES, the factored and offset-table matrix-free GMRES and the
lattice-FFT GMRES), any incident field (`plane_wave` in closed form,
`point_source` or any callable by quadrature), leading batch axes, the
field evaluation (fused on "ba", the general harmonic sum otherwise),
`max_memory`/`max_n_end`, every translation method ("gumerov" by the
Gumerov-Duraiswami recurrences on "ba"/"bpa"), the special functions of
any dimension, the public surfaces of `coords`, `harmonics`,
`special`, `translation`, `biem` and `utils`, several cards or CPU ranks
on one problem (`parallel`, on torch.distributed), and the frontends: the
CLI (`python -m biem_helmholtz_sphere_tpu_torch`), `plot`, `gui` and the
MFS oracle `validation`.

TF32 stays off: reduced-precision matmuls took the float32 sound-soft
boundary residual of the reference from 6e-4 to 2.7e-2.
"""

import torch

from .biem import (
    BIEMKwargs,
    BIEMResultCalculator,
    BIEMResultCalculatorProtocol,
    UinCallable,
    biem,
    biem_u,
    max_memory,
    max_n_end,
    plane_wave,
    point_source,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

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
    "__version__",
]
