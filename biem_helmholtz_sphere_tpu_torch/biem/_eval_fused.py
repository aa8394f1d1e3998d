r"""KA: fused field evaluation on the 3D "ba" tree.

For the "ba" tree Y factorizes as

    Y_{l,m}(th, ph) = e^{i m ph}/sqrt(2 pi) (sin th)^{|m|}
                      p~_{l-|m|}^{(|m|,|m|)}(cos th)

so the contraction of the density with the harmonics regroups per signed
order m and degree l:

    sum_h w_h rad_{l_h} Y_h =
      sum_m  A_m(ph, th) sum_l p~_{l-|m|}^{(|m|)}(cos th) rad_l w2[m, l]

with w2 [..., B, M=2n-1, n] the weights regrouped by (m, l) and rad_l the
outgoing radial factor h_l(k r) (near field) or 1 (far field).

`fused_ba_eval` takes evaluation points and sphere centers, computes the
per (point, ball) angles and clamped h_l(k r) itself, and sums the balls:
on CUDA tensors it launches `csrc/fused_ba_eval.cu`, which keeps every
recurrence in registers, in one of two modes chosen by the shape of the
call (many points: points over threads; few points, P * K < kernels.FEW_POINTS,
e.g. uscat(0): balls over warps and orders over lanes), for real or
complex k and each k's own centers; on CPU tensors it runs
`_fused_ba_eval_plain`,
the degree-major recurrence of the JAX package's
biem_helmholtz_sphere_tpu/biem/_eval_fused.py::_fused_ba_dot_blocked with
the radial table of special/_family.py::_h_clamped.
"""

from functools import lru_cache

import numpy as np
import torch

from ..harmonics._eval import _int_powers
from ..harmonics._index import basis
from ..ops import kernels
from ..special._family import _clamp_limit, _h_clamped, _rescale_for
from ..special._jacobi import jacobi_recurrence

_EVAL_CHUNK = 8192  # points per pass of the plain version (bounds [P, K, B, M])


def is_ba_tree(c):
    """True for the 3D "ba" tree (root 'b' with a single 'a' child)."""
    return (
        c.c_ndim == 3
        and c.root.kind == "b"
        and len(c.root.children) == 1
        and c.root.children[0].kind == "a"
    )


@lru_cache(maxsize=32)
def _fused_tables(n_end):
    """Degree-major slot-space tables of the (|m|, |m|) Jacobi recurrences.

    Slot m (signed, M = 2n-1 of them) runs its family's recurrence
    re-indexed by degree l: zero below l = |m|, seeded with p0 = 1/b0 at
    l = |m|, recurring above.  Returns (m_axis [M], m_abs [M], A, B, B1
    [n(l), M], seed [n(l), M] bool, p0 [M]) as numpy.
    """
    n = n_end
    m_axis = np.arange(-(n - 1), n)
    m_abs = np.abs(m_axis)
    a_tab = np.zeros((n, n + 1))
    b_tab = np.zeros((n, n + 1))
    for f in range(n):
        a_tab[f], b_tab[f] = jacobi_recurrence(n, float(f), float(f))
    lg = np.arange(n)[:, None]
    fg = m_abs[None, :]
    j1 = lg - fg - 1  # recurrence step index, meaningful for l > |m|
    rec = j1 >= 0
    j1c = np.clip(j1, 0, n - 1)
    a_lm = np.where(rec, a_tab[fg, j1c], 0.0)
    b_lm = np.where(rec, b_tab[fg, j1c], 0.0)
    b1_lm = np.where(rec, b_tab[fg, j1c + 1], 1.0)
    seed_lm = lg == fg
    p0_m = 1.0 / b_tab[m_abs, 0]
    return m_axis, m_abs, a_lm, b_lm, b1_lm, seed_lm, p0_m


@lru_cache(maxsize=32)
def _slot_map(c, n_end):
    """(hmap [M, n] flat harmonic index per (m-slot, degree), valid [M, n])."""
    b_ = basis(c, n_end)
    ell = np.array(
        [b_.node_jobs[c.root.nid][j][1] for j in b_.node_job_index[c.root.nid]]
    )
    anid = c.root.children[0].nid
    mm = np.array([b_.node_jobs[anid][j][0] for j in b_.node_job_index[anid]])
    hmap = -np.ones((2 * n_end - 1, n_end), dtype=np.int64)
    hmap[mm + (n_end - 1), ell] = np.arange(b_.num)
    return hmap, hmap >= 0


def regroup(c, n_end, w):
    """Weights [..., B, H] -> w2 [..., B, M, n] by (m-slot, degree); 0 where
    the slot has no harmonic of that degree."""
    hmap, valid = _slot_map(c, n_end)
    idx = torch.as_tensor(np.maximum(hmap, 0), device=w.device)
    valid = torch.as_tensor(valid, device=w.device)
    return torch.where(valid, w[..., idx], 0.0)


@lru_cache(maxsize=8)
def _kernel_coefs(n_end, dtype, device):
    """Per (|m|, step j) recurrence tables for the kernel: -a_j/b_{j+1},
    1/b_{j+1}, b_j/b_{j+1} as [n, n], and p0 [n] (the kernel steps
    p_{j+1} = (cos th / b_{j+1} - a_j / b_{j+1}) p_j - b_j/b_{j+1} p_{j-1})."""
    cab = np.zeros((n_end, n_end))
    cb1 = np.zeros((n_end, n_end))
    cbb = np.zeros((n_end, n_end))
    p0 = np.zeros(n_end)
    for f in range(n_end):
        a, b = jacobi_recurrence(n_end, float(f), float(f))
        cab[f] = -a[:n_end] / b[1 : n_end + 1]
        cb1[f] = 1.0 / b[1 : n_end + 1]
        cbb[f] = b[:n_end] / b[1 : n_end + 1]
        p0[f] = 1.0 / b[0]
    return tuple(
        torch.as_tensor(t, dtype=dtype, device=device) for t in (cab, cb1, cbb, p0)
    )


def _angles(x, centers, far):
    """"ba" angles and radius of x [3, Kx, P] relative to each center of
    centers [K or 1, B, 3]: (theta, phi, r), each [P, K, B] (far field: of
    x itself, [P, Kx, 1])."""
    rel = x[..., None] if far else x[..., None] - centers.permute(2, 0, 1)[:, :, None, :]
    rel = rel.permute(0, 2, 1, 3)  # [3, P, K, B]
    rc = torch.hypot(rel[0], rel[1])
    return torch.atan2(rc, rel[2]), torch.atan2(rel[1], rel[0]), torch.hypot(rc, rel[2])


def _fused_ba_eval_plain(x, centers, k, w2, far, per_ball):
    n = w2.shape[-1]
    centers = centers[None] if centers.ndim == 2 else centers  # [K or 1, B, 3]
    rdt, dev = x.dtype, x.device
    m_axis, m_abs, a_lm, b_lm, b1_lm, seed_lm, p0_m = _fused_tables(n)

    def t(a, dt=rdt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    a_l, binvb1_l, invb1_l = t(a_lm), t(b_lm / b1_lm), t(1.0 / b1_lm)
    seed_l, p0 = t(seed_lm, torch.bool), t(p0_m)
    outs = []
    for s in range(0, x.shape[-1], _EVAL_CHUNK):
        theta, phi, r = _angles(x[..., s : s + _EVAL_CHUNK], centers, far)
        ct = torch.cos(theta)[..., None]  # [P, Kx, B, 1]
        if not far:
            h = _h_clamped(3, n, k[:, None] * r)  # [P, K, B, n]
        shape = torch.broadcast_shapes(ct.shape[:-1], w2.shape[:-2]) + (len(m_axis),)
        pm = torch.zeros(shape, dtype=rdt, device=dev)
        pn = pm
        acc = torch.zeros(shape, dtype=w2.dtype, device=dev)
        for l in range(n):
            pp = (ct - a_l[l]) * pn * invb1_l[l] - binvb1_l[l] * pm
            pp = torch.where(seed_l[l], p0, pp)
            contrib = w2[..., l] * pp
            if not far:
                contrib = contrib * h[..., l, None]
            acc = acc + contrib
            pm, pn = pn, pp
        stpow = _int_powers(torch.sin(theta), n - 1)[..., m_abs]
        az = torch.exp(1j * phi[..., None] * t(m_axis))
        u = (acc * az * stpow).sum(-1) * (1.0 / np.sqrt(2.0 * np.pi))
        outs.append(u if per_ball else u.sum(-1))
    return torch.cat(outs, dim=0)


def fused_ba_eval(x, centers, k, w2, far=False, per_ball=False):
    """sum over balls b of sum_h w_h rad_{l_h} Y_h(x - c_b) on the "ba" tree.

    x: real [3, Kx, P] points (Kx = 1 shares them over the K batch);
    centers: real [K, B, 3], each k's own, or [B, 3] for all (a geometry
    shared by the batch is an expanded view, stride 0 along K: the kernel
    reads it once per k without a copy); k: real or complex [K]; w2:
    complex [K, B, M, n]
    (see `regroup`).  Near field (far=False): angles of x - c_b and
    rad_l = h_l(k |x - c_b|) clamped; far field: angles of x itself and
    rad = 1.  Returns complex [P, K], or [P, K, B] with per_ball=True.
    Launches of the many-point kernel count in `fused_ba_eval.launches`,
    those of the few-point kernel in `fused_ba_eval.few_launches`.
    """
    n_k, n_b, n_m, n = w2.shape
    if x.shape[0] != 3 or x.shape[1] not in (1, n_k) or n_m != 2 * n - 1:
        raise ValueError(
            f"fused_ba_eval: x {tuple(x.shape)}, w2 {tuple(w2.shape)} do not match"
        )
    if centers.shape == (n_b, 3):  # one geometry for the batch: a stride-0 view
        centers = centers.expand(n_k, n_b, 3)
    if centers.shape != (n_k, n_b, 3) or k.shape != (n_k,):
        raise ValueError(
            f"fused_ba_eval: centers {tuple(centers.shape)}, k {tuple(k.shape)}"
        )
    if x.device.type == "cpu":
        return _fused_ba_eval_plain(x, centers, k, w2, far, per_ball)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_ba_eval: unsupported device {x.device}")
    rdt = x.dtype
    cdt = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(rdt)
    if cdt is None or w2.dtype != cdt or centers.dtype != rdt or k.dtype not in (rdt, cdt):
        raise TypeError(
            f"fused_ba_eval: dtypes x {rdt}, centers {centers.dtype}, "
            f"k {k.dtype}, w2 {w2.dtype}"
        )
    if centers.stride()[1:] != (3, 1):  # each k's [B, 3] contiguous; any k stride
        centers = centers.contiguous()
    k, w2 = k.contiguous(), w2.contiguous()
    cab, cb1, cbb, p0 = _kernel_coefs(n, rdt, x.device)
    n_p = x.shape[-1]
    out = torch.empty(
        (n_p, n_k, n_b) if per_ball else (n_p, n_k), dtype=cdt, device=x.device
    )
    sx = x.stride()
    few = n_p * n_k < kernels.FEW_POINTS
    kernels.launch(
        "bhs_fused_ba_eval", x, sx[0], sx[1], sx[2], x.shape[1], centers, centers.stride(0),
        k, int(k.is_complex()), w2, cab, cb1, cbb, p0, out, n_p, n_k, n_b, n, int(far),
        int(per_ball), int(few), _clamp_limit(rdt), _rescale_for(rdt),
        int(rdt == torch.float64),
    )
    if few:
        fused_ba_eval.few_launches += 1
    else:
        fused_ba_eval.launches += 1
    return out


fused_ba_eval.launches = 0
fused_ba_eval.few_launches = 0
