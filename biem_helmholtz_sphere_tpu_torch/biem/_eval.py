r"""Scattered-field evaluation u_scat(x).

Near field (x outside all spheres):

    u_scat(x) = sum_b sum_h phi[b,h] blc_{n_h}(rho_b, eta) h^{(1)}_{n_h}(k r_b)
                Y_h(x^_b),        r_b = |x - c_b|

Far field (x^ a unit direction):

    u_inf(x^) = (ik)^{-(d-1)/2} sum_b e^{-i k x^.c_b}
                sum_h (-i)^{n_h} phi[b,h] blc_{n_h}(rho_b, eta) Y_h(x^)

with Y evaluated at the observation direction x^ itself for every sphere
(the JAX package's far-field convention).  Points inside a sphere
(kind="outer") or outside every sphere (kind="inner") are NaN.  k may be
complex and the centers may vary along the batch.  On the 3D "ba" tree
the harmonic sum runs through the fused kernel
(`_eval_fused.fused_ba_eval`, KA); every other tree takes `harmonic_sum`:
its near field through KE (`ops/harmonic_eval.py`), its far field the
harmonics at x and one `torch.matmul` with the density.
The same semantics as biem_helmholtz_sphere_tpu.biem._eval.biem_u.
"""

import numpy as np
import torch

from ..coords import from_cartesian
from ..harmonics._eval import harmonics
from ..harmonics._index import assume_n_end_from_num, basis
from ..ops import harmonic_eval as _ke
from ..translation._ops import ipow
from ._eval_fused import fused_ba_eval, is_ba_tree, regroup
from ._layer import blc

# bytes of the [K, P_chunk, H] complex harmonics of one chunk of the far
# field in `harmonic_sum`
_EVAL_BYTES = 1 << 30


def harmonic_sum(c, n_end, x, centers, k, w, far=False, per_ball=False):
    """sum_h w_h rad_{n_h} Y_h(x - c_b) per ball, for any tree: complex
    [P, K] (summed over the balls) or [P, K, B] (per_ball).

    x: real [d, Kx, P] (Kx = 1 shares the points over the batch);
    centers: real [K, B, d]; k: real or complex [K]; w: complex [K, B, H].
    Near field: Y at the direction of x - c_b and rad_n = h_n(k |x - c_b|)
    clamped (`_h_clamped`), through KE (`ops/harmonic_eval.py`: the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors).  Far field:
    Y at x itself and rad = 1, the harmonics of a chunk of points (within
    _EVAL_BYTES) and one `torch.matmul` with w, a library product.
    """
    if not far:
        return _ke.harmonic_eval(c, n_end, x, centers, k, w, per_ball=per_ball)
    n_p = x.shape[-1]
    n_k, n_balls, h_num = w.shape
    chunk = max(1, _EVAL_BYTES // (3 * n_k * h_num * w.element_size()))
    outs = []
    for s in range(0, n_p, chunk):
        y = harmonics(c, from_cartesian(c, x[..., s : s + chunk]), n_end)
        u = torch.matmul(y, w.transpose(1, 2))  # [Kx, P, H] @ [K, H, B] -> [K, P, B]
        outs.append(u.transpose(0, 1) if per_ball else u.sum(-1).transpose(0, 1))
    return torch.cat(outs, dim=0)


def biem_u(res, x, /, far_field=False, per_ball=False, expand_x=True):
    """Scattered field at cartesian points x: complex tensor.

    x: [c_ndim, ...(x)] if expand_x else [c_ndim, ...(x), ...(first)].
    Returns [...(x), ...(first)] (plus a trailing B axis if per_ball).
    """
    if res.density is None:
        raise ValueError("The BIEMResult does not have density.")
    c = res.c
    d = c.c_ndim
    density = res.density
    n_balls, h_num = density.shape[-2:]
    n_end = assume_n_end_from_num(c, h_num)
    first = tuple(res.k.shape)
    n_k = max(1, res.k.numel())
    dev = density.device
    rdt = density.real.dtype
    k = res.k.reshape(n_k)
    k = k.to(density.dtype if k.is_complex() else rdt)
    dens = density.reshape(n_k, n_balls, h_num)
    radii = res.radii.to(rdt).expand(first + (n_balls,)).reshape(n_k, n_balls)
    eta = res.eta.to(rdt).expand(first).reshape(n_k)
    # each k's centers; a geometry shared by the batch stays a stride-0 view
    centers = res.centers.to(rdt).broadcast_to(first + (n_balls, d)).reshape(n_k, n_balls, d)

    x = torch.as_tensor(x, dtype=rdt, device=dev)
    if expand_x:
        x_shape = tuple(x.shape[1:])
        pts = x.reshape(d, 1, -1)
    else:
        x_shape = tuple(x.shape[1 : x.ndim - len(first)])
        pts = x.reshape(d, -1, n_k).permute(0, 2, 1)  # [d, K, P]

    sd = blc(c, n_end, k[:, None], radii, eta[:, None])  # [K, B, H]
    w = dens * sd
    if far_field:
        w = w * ipow(-basis(c, n_end).n_root.astype(np.int64), w.dtype, dev)

    def field(far, each):
        if is_ba_tree(c):
            return fused_ba_eval(pts, centers, k, regroup(c, n_end, w), far=far,
                                 per_ball=each)
        return harmonic_sum(c, n_end, pts, centers, k, w, far=far, per_ball=each)

    if far_field:
        u = field(True, True)  # [P, K, B]
        pref = (1j * k) ** (-(d - 1) / 2.0)  # [K]
        ip = (pts[:, :, :, None] * centers.permute(2, 0, 1)[:, :, None, :]).sum(0)  # x^ . c_b
        u = u * pref[:, None] * torch.exp(-1j * k[:, None, None] * ip).transpose(0, 1)
        if not per_ball:
            u = u.sum(-1)
        return u.reshape(x_shape + first + u.shape[2:])

    u = field(False, per_ball)  # [P, K(, B)]
    rel = pts[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, P, B]
    r = torch.linalg.vector_norm(rel, dim=0).transpose(0, 1)  # [P, K, B]
    if res.kind == "outer":
        invalid = (r < radii).any(-1)
    elif res.kind == "inner":
        invalid = (r > radii).any(-1)
    else:
        raise ValueError(f"Invalid kind: {res.kind}")
    if per_ball:
        invalid = invalid[..., None]
    u = torch.where(invalid, torch.full((), complex("nan+nanj"), dtype=u.dtype, device=dev), u)
    return u.reshape(x_shape + first + u.shape[2:])
