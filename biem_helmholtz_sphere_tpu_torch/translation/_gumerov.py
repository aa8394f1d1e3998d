r"""Gumerov-Duraiswami recurrence coaxial translation (3D).

The coaxial (along the root axis) translation coefficients E^m_{n',n}(t),
defined by  S_{n,m}(y + t e_z) = sum_{n'} E^m_{n',n}(t) R_{n',m}(y),
are filled from the n' column of radial functions by two exact ladders:

  init       E^0_{n',0} = (-1)^{n'} sqrt(2n'+1) c_{n'}(kt)
             (c = h^{(1)} for (S|R), j for (R|R))
  sectorial  b1(m,m) E^{m+1}_{n',m+1} = b1(n'-1,m) E^m_{n'-1,m}
                                        + b2(n'+1,m) E^m_{n'+1,m}
  n-advance  a^m_n E^m_{n',n+1} = a^m_{n-1} E^m_{n',n-1}
                                  - a^m_{n'} E^m_{n'+1,n}
                                  + a^m_{n'-1} E^m_{n'-1,n}

with  a^m_n  = sqrt(((n+1+m)(n+1-m)) / ((2n+1)(2n+3)))      (0 for n < m)
      b1(n,m) = sqrt(((n+m+1)(n+m+2)) / ((2n+1)(2n+3)))
      b2(n,m) = sqrt(((n-m-1)(n-m))   / ((2n-1)(2n+1)))     (0 for n <= m)

The coefficients are independent of sign(m), and the matrix lands in the
package's orthonormal basis (the (-1)^{n'} start carries the i^{l'-l}
factor of the quadrature path).  The same ladders as
biem_helmholtz_sphere_tpu.translation._gumerov, as two Python loops of
n_end - 1 tensor steps each.  Every coefficient is real, so the ladders
run on the real and imaginary parts as one real tensor: an overflowed
h_{n'} then spreads exactly as it does in the JAX package's real pairs
(a complex product with a real factor would turn inf into inf + nan i).

The full (S|R)(t) follows the rotation sandwich of the default route:
SR(t) = D(R) Coax(|t|) D(R)^H (`_rotation._sandwich`), with the ladders
run at the distinct radii only.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..harmonics._index import basis
from ..ops.kernels import as_tensors
from ..special._family import spherical_jh_all
from ._rotation import _offsets_of, _sandwich


def _require_gumerov_tree(c):
    """method="gumerov" is for the 3D "ba" (and "bpa") tree only."""
    if (
        c.c_ndim != 3
        or c.root.kind not in ("b", "bp")
        or len(c.root.children) != 1
        or c.root.children[0].kind != "a"
    ):
        raise ValueError(
            'method="gumerov" is only available for the 3D "ba" tree '
            "(reference: _biem.py:569-572)"
        )


def _a_np(m, n):
    m = np.asarray(m, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    num = np.maximum((n + 1 + m) * (n + 1 - m), 0.0)
    val = np.sqrt(num / ((2 * n + 1) * (2 * n + 3)))
    return np.where(n >= m, val, 0.0)


def _b1_np(n, m):
    # n = -1 rows are masked by the caller (zeroed); keep sqrt clean
    n = np.maximum(np.asarray(n, dtype=np.float64), 0.0)
    return np.sqrt((n + m + 1) * (n + m + 2) / ((2 * n + 1) * (2 * n + 3)))


def _b2_np(n, m):
    n = np.asarray(n, dtype=np.float64)
    val = np.sqrt(
        (n - m - 1) * (n - m) / np.maximum((2 * n - 1) * (2 * n + 1), 1.0)
    )
    return np.where(n - m - 1 >= 0, val, 0.0)


@lru_cache(maxsize=32)
def _gd_tables(c, n_end):
    """Static coefficient and index tables (host numpy, float64 or index),
    shaped to broadcast against the real-pair state [..., M, NPL, 2]."""
    n = n_end
    npl = 3 * n + 2  # n' head-room: output n + one per n-step + one per m-step
    nprime = np.arange(npl)

    # sectorial ladder tables, m = 0..n-2 -> order m+1
    ms = np.arange(n - 1)[:, None]
    b1_prev = _b1_np(nprime[None, :] - 1, ms)  # coef on s[n'-1]
    b1_prev[:, 0] = 0.0
    b2_next = _b2_np(nprime[None, :] + 1, ms)  # coef on s[n'+1]

    # n-advance tables over the [m, n'] grid
    m_all = np.arange(n)[:, None]
    a_np_m1 = _a_np(m_all, nprime[None, :] - 1)  # a^m_{n'-1} [M, NPL]
    a_np_m1[:, 0] = 0.0
    a_col = _a_np(m_all, np.arange(n + 1)[None, :])  # a^m_n [M, N+1]
    a_n = a_col[:, : n - 1].T  # a^m_n per n-step [N-1, M]
    a_nm1 = np.concatenate([np.zeros((1, n)), a_col[:, : n - 2].T])[: n - 1]  # a^m_{n-1}

    # flat-basis gather: per harmonic h, root degree l and signed child m
    b = basis(c, n_end)
    root_jobs = b.node_jobs[c.root.nid]
    ell = np.array(
        [root_jobs[j][1] for j in b.node_job_index[c.root.nid]], dtype=np.int64
    )
    anid = c.root.children[0].nid
    a_jobs = b.node_jobs[anid]
    mm = np.array([a_jobs[j][0] for j in b.node_job_index[anid]], dtype=np.int64)
    return dict(
        sgn=((-1.0) ** nprime * np.sqrt(2.0 * nprime + 1.0))[:, None],  # [NPL, 1]
        b1p=b1_prev[..., None],  # [N-1, NPL, 1]
        b2n=b2_next[..., None],  # [N-1, NPL, 1]
        inv_b1d=1.0 / _b1_np(ms[:, 0], ms[:, 0]),  # 1 / b1(m, m) [N-1]
        ag=_a_np(m_all, nprime[None, :])[..., None],  # a^m_{n'} [M, NPL, 1]
        am1=a_np_m1[..., None],  # [M, NPL, 1]
        a_nm1=a_nm1.reshape(n - 1, n, 1, 1),
        inv_den=(1.0 / np.where(a_n > 0, a_n, 1.0)).reshape(n - 1, n, 1, 1),
        m_iota=m_all[..., None],  # m [M, 1, 1]
        # into the ladders' output [..., M, N (n' < n_end), N] flattened
        idx=np.abs(mm)[None, :] * (n * n) + ell[:, None] * n + ell[None, :],  # [H, H]
        same_m=mm[:, None] == mm[None, :],  # [H, H]
    )


@lru_cache(maxsize=16)
def _gd_tensors(c, n_end, rdt, device):
    """`_gd_tables` on a device, its real tables in the ladders' dtype."""
    return SimpleNamespace(**{
        name: torch.as_tensor(v, dtype=rdt if v.dtype == np.float64 else None, device=device)
        for name, v in _gd_tables(c, n_end).items()
    })


def _down(s):
    """s[..., n'-1, :] with a zero at n' = 0 (the real-pair state's NPL axis)."""
    return F.pad(s[..., :-1, :], (0, 0, 1, 0))


def _up(s):
    """s[..., n'+1, :] with a zero at the last n'."""
    return F.pad(s[..., 1:, :], (0, 0, 0, 1))


def gd_coaxial(c, r, n_end, k, kind="SR"):
    """Coaxial translation matrix by the G-D recurrences: complex [..., H, H].

    The counterpart of `_rotation.coaxial_sr` for the 3D "ba"/"bpa" tree:
    r [...] are translation distances along the root axis, k (real or
    complex) broadcasts against them.  The radial column c_{n'}(k r) at
    3 n_end + 2 orders is one K5 launch in its unscaled mode on CUDA
    tensors; the ladders are plain tensor steps on the device of r and k
    (the card when neither is a tensor).  Like the JAX package's, the
    float32 values overflow where h_{n'}(k r) does.
    """
    _require_gumerov_tree(c)
    if kind not in ("SR", "RR"):
        raise ValueError(f"kind must be 'SR' or 'RR', got {kind!r}")
    r, k = as_tensors(r, k)
    z = k * r
    t = _gd_tensors(c, n_end, z.real.dtype, z.device)
    jf, _, hf, _ = spherical_jh_all(3, 3 * n_end + 2, z)
    e0 = torch.view_as_real((hf if kind == "SR" else jf).contiguous()) * t.sgn

    # the sectorial ladder: every lowest-degree slice E^m_{n',m}, [..., M, NPL, 2]
    sect = [e0]
    for m in range(n_end - 1):
        s = sect[-1]
        sect.append((_down(s) * t.b1p[m] + _up(s) * t.b2n[m]) * t.inv_b1d[m])
    sect = torch.stack(sect, dim=-3)

    # the n-advance ladder: columns E^m_{n',n}, vectorized over (m, n'); the
    # state keeps the head-room rows, the output only n' < n_end
    e_cur = torch.where(t.m_iota == 0, sect, 0.0)
    e_prev = torch.zeros_like(e_cur)
    cols = [e_cur[..., :n_end, :]]
    for j in range(n_end - 1):
        num = e_prev * t.a_nm1[j] - _up(e_cur) * t.ag + _down(e_cur) * t.am1
        e_next = num * t.inv_den[j]
        e_next = torch.where(t.m_iota == j + 1, sect,
                             torch.where(t.m_iota <= j, e_next, 0.0))
        cols.append(e_next[..., :n_end, :])
        e_prev, e_cur = e_cur, e_next
    e_all = torch.view_as_complex(torch.stack(cols, dim=-2))  # [..., M, N, N]
    out = e_all.flatten(-3)[..., t.idx]  # [..., H, H]
    return torch.where(t.same_m, out, 0.0)


def sr_gumerov(c, t_sph, n_end, k, kind="SR", t_cart=None):
    """(S|R) (or (R|R)) by rotation + the G-D coaxial factor: complex
    [..., H, H].

    The offsets by their spherical mapping (with "r"), or by cartesian
    t_cart [d, ...]; k real or complex, broadcasting against their batch
    shape.  Built as `_rotation.sr_rotation` is: the ladders at the
    distinct radii (`_offsets_of`), taken to one factor per offset, then
    the degree-group sandwich with the cached D.
    """
    _require_gumerov_tree(c)
    k = as_tensors(t_cart if t_cart is not None else t_sph["r"], k)[1]
    r, pick, rot = _offsets_of(c, n_end, t_sph, t_cart, k)
    return _sandwich(pick(gd_coaxial(c, r, n_end, k, kind=kind)), rot)
