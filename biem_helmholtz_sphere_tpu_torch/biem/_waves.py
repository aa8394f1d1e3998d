"""Incident-wave factories: plane wave and point source.

`plane_wave` and `point_source` return (u_in, grad u_in) closures with the
JAX package's broadcast convention: input x of shape (c_ndim, ...(any),
...batch) where the trailing axes align with the factory's own
k/direction (or source) batch shape.  k is real or complex.
"""

import torch

from ..ops.kernels import default_device
from ..special._shn1 import shn1


def _as_tensor(x, like=None):
    """x as a floating or complex tensor on like's device; with no like,
    on the card (CPU tensors are how a caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else default_device()
    t = torch.as_tensor(x, device=dev)
    return t if t.is_floating_point() or t.is_complex() else t.to(torch.get_default_dtype())


def _check_k(k, name, v):
    """The factories' checks of k against direction / source [c_ndim, ...]."""
    try:
        torch.broadcast_shapes(k.shape, v.shape[1:])
    except RuntimeError as e:
        raise ValueError(
            f"Shapes of k and {name}[1:] are not broadcastable: "
            f"{tuple(k.shape)} vs {tuple(v.shape[1:])}"
        ) from e
    if v.ndim != k.ndim + 1:
        raise ValueError(f"{name}.ndim={v.ndim} is not k.ndim+1={k.ndim + 1}")


def plane_wave(*, k, direction):
    r"""Plane wave u(x) = e^{i k d.x} with d = direction/|direction|.

    k: real or complex [...]; direction: real [c_ndim, ...].  Returns (u_in, grad_u_in);
    both produce complex tensors, on k's device (the card where k is not a
    tensor).

    >>> import torch
    >>> uin, grad = plane_wave(k=torch.tensor(2.0, dtype=torch.float64),
    ...                        direction=torch.tensor([1.0, 0.0], dtype=torch.float64))
    >>> complex(uin(torch.zeros(2, 1, dtype=torch.float64))[0])  # e^0
    (1+0j)
    >>> z = complex(uin(torch.tensor([[torch.pi / 4], [0.0]], dtype=torch.float64))[0])
    >>> print(f"{z:.6f}")  # e^{i k pi/4} = i at k=2
    0.000000+1.000000j
    """
    k = _as_tensor(k)
    direction = _as_tensor(direction, like=k)
    _check_k(k, "direction", direction)
    direction = direction / torch.linalg.vector_norm(direction, dim=0, keepdim=True)

    def _dir(x):
        return direction[(slice(None),) + (None,) * (x.ndim - direction.ndim) + (...,)]

    def uin(x, /):
        x = _as_tensor(x, like=k)
        return torch.exp(1j * k * (_dir(x) * x).sum(dim=0))

    def uin_grad(x, /):
        x = _as_tensor(x, like=k)
        dd = _dir(x)
        return torch.exp(1j * k * (dd * x).sum(dim=0))[None] * dd * (1j * k)

    # Shared tag consumed by biem()'s analytic right-hand side: both
    # closures of one plane_wave(...) call carry the SAME tuple.
    tag = ("plane_wave", k, direction)
    uin._analytic = tag
    uin_grad._analytic = tag
    return uin, uin_grad


def point_source(*, k, source, n=0):
    r"""Point source u(x) = h^{(1)}_n(k |x - source|) in d dimensions.

    k: real or complex [...]; source: real [c_ndim, ...].  Returns (u_in, grad_u_in);
    both produce complex tensors, on k's device (the card where k is not a
    tensor).  h_n runs through `special.shn1` (K5 on the card).

    >>> import torch
    >>> uin, grad = point_source(k=torch.tensor(1.0, dtype=torch.float64),
    ...                          source=torch.tensor([0.0, 0.0, 3.0], dtype=torch.float64))
    >>> u = complex(uin(torch.zeros(3, 1, dtype=torch.float64))[0])  # h_0^(1)(3)
    >>> print(f"{u:.6f}")  # sin(3)/3 - i cos(3)/3
    0.047040+0.329997j
    """
    k = _as_tensor(k)
    source = _as_tensor(source, like=k)
    _check_k(k, "source", source)

    def _rel(x):
        x = _as_tensor(x, like=k)
        return x - source[(slice(None),) + (None,) * (x.ndim - source.ndim) + (...,)]

    def uin(x, /):
        xr = _rel(x)
        r = torch.linalg.vector_norm(xr, dim=0)
        return shn1(n, xr.shape[0], k * r)

    def uin_grad(x, /):
        xr = _rel(x)
        r = torch.linalg.vector_norm(xr, dim=0)
        coeff = shn1(n, xr.shape[0], k * r, derivative=True) * k / r
        return coeff[None] * xr

    return uin, uin_grad
