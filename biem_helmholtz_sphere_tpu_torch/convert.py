"""State carried across from the JAX package.

The system has no weights: its state is the solved density.  `from_numpy`
turns the arrays of a JAX result (complex arrays made numpy with
`.to_numpy()`) into the port's result on a given device, so the port's
field evaluation can run on a density the JAX package solved.
"""

import numpy as np
import torch

from .biem._core import BIEMResultCalculator
from .harmonics._index import basis
from .ops.kernels import default_device


def from_numpy(c, n_end, centers, radii, k, eta, density, *, kind="outer",
               device=None, dtype=None):
    """BIEMResultCalculator from numpy arrays.

    centers [..., B, d] (one geometry, or each k's own), radii [..., B],
    eta [...] real; k [...] real or complex; density [..., B, H] complex.
    device: None means the card (raises where CUDA is absent); pass
    device="cpu" for the CPU.  dtype is the complex dtype of the result
    (default: complex128 for float64 inputs, else complex64).
    """
    if device is None:
        device = default_device()
    density = np.asarray(density)
    if dtype is None:
        dtype = torch.complex128 if density.dtype == np.complex128 else torch.complex64
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32

    def real(a):
        return torch.tensor(np.array(a, dtype=np.float64), dtype=rdt, device=device)

    if eta is None:
        eta = np.ones(np.shape(k))
    k = np.asarray(k)
    k = (torch.tensor(k.astype(np.complex128), dtype=dtype, device=device)
         if np.iscomplexobj(k) else real(k))
    if density.shape[-1] != basis(c, n_end).num:
        raise ValueError(
            f"density has {density.shape[-1]} harmonics, not the "
            f"{basis(c, n_end).num} of n_end={n_end}"
        )
    return BIEMResultCalculator(
        c=c,
        centers=real(centers),
        radii=real(radii),
        k=k,
        eta=real(eta),
        density=torch.as_tensor(density, dtype=dtype, device=device),
        n_end=n_end,
        kind=kind,
    )
