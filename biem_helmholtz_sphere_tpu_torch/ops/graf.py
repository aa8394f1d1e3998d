r"""KG: the 2D Graf (S|R) table, with the exponent fold.

In 2D (Y_m = e^{i m phi} / sqrt(2 pi), degree |m|) Graf's addition theorem
gives the translation operator in closed form: for an offset t = (|t|,
theta) and mu = m - m' (in - out),

    M[h', h] = i^{|m'| - |m| + |mu|} C_{|mu|}(k |t|) e^{i mu theta}

with C = H^{(1)} for (S|R) and J for (R|R), from the d = 2 family of K5
(C = sqrt(2/pi) times its h or j).  Scale-compensated, C carries a
mantissa and an exponent, S[h', h] = e[|mu|], and the BIEM routes fold
the ball-maximum row and column exponents into each entry:

    table[k, o, h', h] = mant[k, o, |mu|] sqrt(2/pi) i^p e^{i mu theta[k, o]}
                         exp(e_r[k, h'] + e[k, o, |mu|] + e_b[k, h])

The JAX package builds it by gathers, i-powers and exponentials that XLA
fused (biem_helmholtz_sphere_tpu/translation/_scaled.py::graf_2d_scaled
with the fold of biem/_core.py and biem/_lattice.py, and
translation/_ops.py::_graf_2d unscaled).  `graf_fold` runs the CUDA kernel
`csrc/graf_fold.cu` on CUDA tensors and `_graf_fold_plain` on CPU tensors;
with no exponent table it is the unscaled `_graf_2d` (zero-exponent mode).
It feeds KD's table on the 2D dense routes, the 2D offset-table route and
the 2D lattice kernel build.
"""

import numpy as np
import torch

from . import kernels

_SQRT_2_PI = float(np.sqrt(2.0 / np.pi))
_SMEM = 232448  # the H100's shared memory per block (csrc/graf_fold.cu's table)


def _ipow(p, cdt):
    """i**p for an integer tensor p (negative too): complex tensor."""
    units = torch.tensor([1, 1j, -1, -1j], dtype=cdt, device=p.device)
    return units[p % 4]


def graf_gather(tab, theta, m_out, m_in, e_tab=None):
    """The Graf entries from their order tables: (mant, S).

    tab: complex [..., NMU] (K5's h or j, or their mantissas, at k |t|,
    orders 0..NMU-1); theta: real [...] (the offsets' angles,
    broadcasting against tab's batch); m_out [Ho], m_in [Hi]: int64
    signed orders; e_tab: real [..., NMU] exponents or None.  Returns
    mant = sqrt(2/pi) tab[|mu|] i^{|m'|-|m|+|mu|} e^{i mu theta} [...,
    Ho, Hi] and S = e_tab[|mu|] (None without e_tab), mu = m - m'.
    """
    mu = m_in[None, :] - m_out[:, None]  # [Ho, Hi], in - out
    a = mu.abs()
    rdt = theta.dtype
    gathered = (tab * _SQRT_2_PI)[..., a]
    ip = _ipow(m_out.abs()[:, None] - m_in.abs()[None, :] + a, tab.dtype)
    ang = theta[..., None, None] * mu.to(rdt)
    phase = torch.polar(torch.ones_like(ang), ang)
    mant = gathered * ip * phase
    return mant, None if e_tab is None else e_tab[..., a]


def _graf_fold_plain(tab, e_tab, theta, m_out, m_in, e_r, e_b):
    """Plain version of the KG kernel (and its CPU path); arguments as
    `graf_fold`."""
    n_k, n_off = tab.shape[:2]
    theta = theta.expand(n_k, n_off)
    mant, s_mat = graf_gather(tab, theta, m_out.long(), m_in.long(), e_tab)
    if s_mat is None:
        return mant
    return mant * torch.exp(e_r[:, None, :, None] + s_mat + e_b[:, None, None, :])


def graf_fold(tab, theta, m_out, m_in, e_tab=None, e_r=None, e_b=None):
    """KG wrapper: the 2D (S|R) (or (R|R)) table [K, NO, Ho, Hi].

    tab: complex [K, NO, NMU], the order table of each (k, offset) (K5's
    h or j, or the mantissas of h), with NMU > max|m_in| + max|m_out|
    (for a 2D basis of H orders max|m| = (H - 1) / 2);
    theta: real [K, NO] or [1, NO] (one geometry: read at k stride 0);
    m_out [Ho], m_in [Hi]: int signed orders of the output and input
    harmonics; e_tab: real [K, NO, NMU] exponents of tab, with e_r [K, Ho]
    and e_b [K, Hi] the row and column exponents folded in, or all three
    None (zero-exponent mode: the unscaled `_graf_2d`).  On CPU tensors
    this runs the plain version; on CUDA tensors it launches
    csrc/graf_fold.cu or raises.
    """
    n_k, n_off, n_mu = tab.shape
    h_out, h_in = m_out.shape[0], m_in.shape[0]
    fold = e_tab is not None
    if (fold != (e_r is not None) or fold != (e_b is not None)
            or theta.shape not in ((n_k, n_off), (1, n_off))
            or (fold and (e_tab.shape != tab.shape or e_r.shape != (n_k, h_out)
                          or e_b.shape != (n_k, h_in)))):
        raise ValueError(
            f"graf_fold: tab {tuple(tab.shape)}, theta {tuple(theta.shape)}, m_out "
            f"{tuple(m_out.shape)}, m_in {tuple(m_in.shape)}, e_tab, e_r, e_b "
            f"{[None if t is None else tuple(t.shape) for t in (e_tab, e_r, e_b)]} "
            "do not match"
        )
    # the orders of a 2D basis reach |m| = (H - 1) / 2 (checked from the
    # shapes, without a device sync; on the card an entry past the table
    # comes out NaN)
    if 2 * n_mu < h_out + h_in - 1:
        raise ValueError(f"graf_fold: {n_mu} orders do not reach the largest |m - m'|")
    if tab.device.type == "cpu":
        return _graf_fold_plain(tab, e_tab, theta, m_out, m_in, e_r, e_b)
    if tab.device.type != "cuda":
        raise RuntimeError(f"graf_fold: unsupported device {tab.device}")
    cdt = tab.dtype
    rdt = kernels.REAL_OF.get(cdt)
    reals = (theta,) + ((e_tab, e_r, e_b) if fold else ())
    if rdt is None or any(t.dtype != rdt for t in reals):
        raise TypeError(
            f"graf_fold: dtypes tab {cdt}, theta {theta.dtype}"
            + (f", e_tab {e_tab.dtype}, e_r {e_r.dtype}, e_b {e_b.dtype}" if fold else "")
        )
    m_out, m_in = m_out.to(torch.int32), m_in.to(torch.int32)
    csize = tab.element_size()
    smem = (2 * n_mu - 1) * csize + (n_mu * csize // 2 if fold else 0)
    if smem > _SMEM:
        raise ValueError(
            f"graf_fold: the phase table of {n_mu} orders needs {smem} bytes of shared "
            f"memory, more than a block's {_SMEM}"
        )
    tab, theta, m_out, m_in = (t.contiguous() for t in (tab, theta, m_out, m_in))
    if fold:
        e_tab, e_r, e_b = e_tab.contiguous(), e_r.contiguous(), e_b.contiguous()
    # rows per CTA: a few thousand entries, and at least four per phase-table entry
    rows = min(h_out, max(-(-4096 // h_in), -(-4 * (2 * n_mu - 1) // h_in)))
    out = torch.empty((n_k, n_off, h_out, h_in), dtype=cdt, device=tab.device)
    kernels.launch(
        "bhs_graf_fold", tab, e_tab if fold else 0, theta, n_off if theta.shape[0] > 1 else 0,
        m_out, m_in, e_r if fold else 0, e_b if fold else 0, out, n_k, n_off, n_mu, h_out,
        h_in, rows, smem, _SQRT_2_PI, int(fold), int(cdt == torch.complex128),
    )
    graf_fold.launches += 1
    return out


graf_fold.launches = 0
