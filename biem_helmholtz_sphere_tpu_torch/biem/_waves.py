"""Incident plane wave.

`plane_wave` returns (u_in, grad u_in) closures with the JAX package's
broadcast convention: input x of shape (c_ndim, ...(any), ...batch) where
the trailing axes align with the wave's own k/direction batch shape.
Point sources are not ported yet (ROADMAP queue 1 item 8).
"""

import torch

from ..ops.kernels import default_device


def _as_real(x, like=None):
    """x as a tensor on like's device; with no like, on the card (CPU
    tensors are how a caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else default_device()
    t = torch.as_tensor(x, device=dev)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def plane_wave(*, k, direction):
    r"""Plane wave u(x) = e^{i k d.x} with d = direction/|direction|.

    k: real [...]; direction: real [c_ndim, ...].  Returns (u_in, grad_u_in);
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
    k = _as_real(k)
    direction = _as_real(direction, like=k)
    if k.is_complex():
        raise NotImplementedError(
            "complex k is not ported yet (ROADMAP queue 1 item 8)"
        )
    try:
        torch.broadcast_shapes(k.shape, direction.shape[1:])
    except RuntimeError as e:
        raise ValueError(
            "Shapes of k and direction[1:] are not broadcastable: "
            f"{tuple(k.shape)} vs {tuple(direction.shape[1:])}"
        ) from e
    if direction.ndim != k.ndim + 1:
        raise ValueError(f"direction.ndim={direction.ndim} is not k.ndim+1={k.ndim + 1}")
    direction = direction / torch.linalg.vector_norm(direction, dim=0, keepdim=True)

    def _dir(x):
        return direction[(slice(None),) + (None,) * (x.ndim - direction.ndim) + (...,)]

    def uin(x, /):
        x = _as_real(x, like=k)
        return torch.exp(1j * k * (_dir(x) * x).sum(dim=0))

    def uin_grad(x, /):
        x = _as_real(x, like=k)
        dd = _dir(x)
        return torch.exp(1j * k * (dd * x).sum(dim=0))[None] * dd * (1j * k)

    # Shared tag consumed by biem()'s analytic right-hand side: both
    # closures of one plane_wave(...) call carry the SAME tuple.
    tag = ("plane_wave", k, direction)
    uin._analytic = tag
    uin_grad._analytic = tag
    return uin, uin_grad
