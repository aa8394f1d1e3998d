"""Hyperspherical harmonic evaluation Y_h at arbitrary angles.

Each tree node evaluates a table of its distinct 1-D factors, then the
flat harmonic axis is assembled by gathers and a product.  Factor
conventions (orthonormal w.r.t. the node's surface measure), as in
biem_helmholtz_sphere_tpu.harmonics._eval:

  'a'  : e^{i m phi} / sqrt(2 pi)
  'b'  : (sin th)^{nc} p~_{l-nc}^{(lam,lam)}(cos th),  lam = nc + (s-1)/2
  'c'  : 2^{(n1+n2)/2 + (s1+s2)/4 + 1/2} (cos th)^{n1} (sin th)^{n2}
         p~_j^{(n2+(s2-1)/2, n1+(s1-1)/2)}(cos 2 th),  j = (l-n1-n2)/2

with p~ the orthonormal Jacobi family (special/_jacobi.py) and s, s1, s2
the children's sphere dimensions.
"""

import numpy as np
import torch

from ..special._jacobi import orthonormal_jacobi_table
from ._index import basis


def _int_powers(x, n_max):
    """[..., n_max+1] with entry i = x**i."""
    ones = torch.ones_like(x)[..., None]
    if n_max == 0:
        return ones
    rep = x[..., None].expand(*x.shape, n_max)
    return torch.cumprod(torch.cat([ones, rep], dim=-1), dim=-1)


def _node_table(node, jobs, spherical):
    """[..., n_jobs] factor values for one node at its angle (real tensor)."""
    ang = spherical[node.nid]
    if node.kind == "a":
        ms = torch.as_tensor([p[0] for p in jobs], dtype=ang.dtype, device=ang.device)
        return torch.polar(
            torch.full_like(ang[..., None] * ms, 1.0 / np.sqrt(2.0 * np.pi)),
            ang[..., None] * ms,
        )
    if node.kind in ("b", "bp"):
        s = node.children[0].sdim
        ncs = sorted({p[0] for p in jobs})
        fam_of = {nc: i for i, nc in enumerate(ncs)}
        maxdeg = max(p[1] - p[0] for p in jobs)
        alphas = [nc + (s - 1) / 2.0 for nc in ncs]
        table = orthonormal_jacobi_table(torch.cos(ang), maxdeg, alphas, alphas)
        sinpow = _int_powers(torch.sin(ang), max(ncs))[..., ncs]  # [..., F]
        fidx = [fam_of[p[0]] for p in jobs]
        didx = [p[1] - p[0] for p in jobs]
        return sinpow[..., fidx] * table[..., fidx, didx]
    # 'c': the Jacobi table in cos 2 theta of each (n1, n2) family
    s1, s2 = node.children[0].sdim, node.children[1].sdim
    fams = sorted({(p[0], p[1]) for p in jobs})
    fam_of = {f: i for i, f in enumerate(fams)}
    maxj = max((p[2] - p[0] - p[1]) // 2 for p in jobs)
    alphas = [n2 + (s2 - 1) / 2.0 for _, n2 in fams]
    betas = [n1 + (s1 - 1) / 2.0 for n1, _ in fams]
    table = orthonormal_jacobi_table(torch.cos(2.0 * ang), maxj, alphas, betas)
    n1s, n2s = [f[0] for f in fams], [f[1] for f in fams]
    norm = torch.as_tensor(
        2.0 ** ((np.array(n1s) + np.array(n2s)) / 2.0 + (s1 + s2) / 4.0 + 0.5),
        dtype=ang.dtype, device=ang.device)
    fampow = (norm * _int_powers(torch.cos(ang), max(n1s))[..., n1s]
              * _int_powers(torch.sin(ang), max(n2s))[..., n2s])
    fidx = [fam_of[(p[0], p[1])] for p in jobs]
    jidx = [(p[2] - p[0] - p[1]) // 2 for p in jobs]
    return fampow[..., fidx] * table[..., fidx, jidx]


class Phase(int):
    """Phase-convention marker, as the JAX package's: the harmonics use the
    fixed e^{i m phi} convention, which is Phase(0); other values raise."""

    def __new__(cls, v=0):
        if int(v) != 0:
            raise NotImplementedError(
                "only the Phase(0) (e^{i m phi}) convention is implemented"
            )
        return super().__new__(cls, v)


def harmonics(c, spherical, n_end, phase=None):
    """Evaluate all Y_h, h = 0..num-1, at the given angles: complex [..., num].

    `spherical` maps node id -> real angle tensor (broadcastable shapes);
    the radius entry "r", if present, is ignored.  `phase` takes Phase(0)
    (or 0), the one convention implemented.
    """
    if phase is not None:
        Phase(phase)
    b = basis(c, n_end)
    out = None
    for node in c.nodes:
        tab = _node_table(node, b.node_jobs[node.nid], spherical)
        idx = torch.as_tensor(b.node_job_index[node.nid], device=tab.device)
        v = tab.index_select(-1, idx)
        out = v if out is None else out * v
    return out if out.is_complex() else out.to(
        torch.complex128 if out.dtype == torch.float64 else torch.complex64
    )
