r"""Scattered-field evaluation u_scat(x).

Near field (x outside all spheres):

    u_scat(x) = sum_b sum_h phi[b,h] blc_{n_h}(rho_b, eta) h^{(1)}_{n_h}(k r_b)
                Y_h(x^_b),        r_b = |x - c_b|

Far field (x^ a unit direction):

    u_inf(x^) = (ik)^{-(d-1)/2} sum_b e^{-i k x^.c_b}
                sum_h (-i)^{n_h} phi[b,h] blc_{n_h}(rho_b, eta) Y_h(x^)

Points inside a sphere (kind="outer") or outside every sphere
(kind="inner") are NaN.  The harmonic sum runs through the fused "ba"
kernel (`_eval_fused.fused_ba_eval`); the same semantics as
biem_helmholtz_sphere_tpu.biem._eval.biem_u.
"""

import numpy as np
import torch

from ..harmonics._index import assume_n_end_from_num, basis
from ..translation._ops import ipow
from ._eval_fused import fused_ba_eval, is_ba_tree, regroup
from ._layer import blc


def biem_u(res, x, /, far_field=False, per_ball=False, expand_x=True):
    """Scattered field at cartesian points x: complex tensor.

    x: [c_ndim, ...(x)] if expand_x else [c_ndim, ...(x), ...(first)].
    Returns [...(x), ...(first)] (plus a trailing B axis if per_ball).
    """
    if res.density is None:
        raise ValueError("The BIEMResult does not have density.")
    c = res.c
    if not is_ba_tree(c):
        raise NotImplementedError(
            "field evaluation is ported for the 3D 'ba' tree only "
            "(ROADMAP queue 1 item 9)"
        )
    density = res.density
    n_balls, h_num = density.shape[-2:]
    n_end = assume_n_end_from_num(c, h_num)
    first = tuple(res.k.shape)
    n_k = max(1, res.k.numel())
    dev = density.device
    rdt = density.real.dtype
    k = res.k.reshape(n_k).to(rdt)
    dens = density.reshape(n_k, n_balls, h_num)
    radii = res.radii.to(rdt).expand(first + (n_balls,)).reshape(n_k, n_balls)
    eta = res.eta.to(rdt).expand(first).reshape(n_k)
    centers = res.centers.to(rdt).reshape(-1, n_balls, 3)[0]

    x = torch.as_tensor(x, dtype=rdt, device=dev)
    if expand_x:
        x_shape = tuple(x.shape[1:])
        pts = x.reshape(3, 1, -1)
    else:
        x_shape = tuple(x.shape[1 : x.ndim - len(first)])
        pts = x.reshape(3, -1, n_k).permute(0, 2, 1)  # [3, K, P]

    sd = blc(c, n_end, k[:, None], radii, eta[:, None])  # [K, B, H]
    w = dens * sd
    if far_field:
        w = w * ipow(-basis(c, n_end).n_root.astype(np.int64), w.dtype, dev)
    w2 = regroup(c, n_end, w)

    if far_field:
        u = fused_ba_eval(pts, centers, k, w2, far=True, per_ball=True)
        pref = (1j * k) ** (-(3 - 1) / 2.0)  # [K]
        ip = torch.einsum("dkp,bd->pkb", pts, centers)  # x^ . c_b
        u = u * pref[:, None] * torch.exp(-1j * k[:, None] * ip)
        if not per_ball:
            u = u.sum(-1)
        return u.reshape(x_shape + first + u.shape[2:])

    u = fused_ba_eval(pts, centers, k, w2, per_ball=per_ball)  # [P, K(, B)]
    rel = pts[..., None] - centers.T[:, None, None, :]  # [3, K?, P, B]
    r = torch.linalg.vector_norm(rel, dim=0).transpose(0, 1)  # [P, K?, B]
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
