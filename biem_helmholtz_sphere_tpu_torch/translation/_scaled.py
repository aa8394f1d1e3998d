r"""Scale-compensated coaxial (S|R) factor: mantissa + per-entry exponent.

The (S|R) entries scale like |h_{l+l'}(k t)|, which overflows float32
from n_end ~ k t + 20.  `coaxial_scaled` returns the coaxial factor as
(mant, S): SR_e = mant * exp(S), with S[h', h] = log|h_{l+l'}(kr)| and
|mant| ~ O(1).  The band contraction sum_n coef_n U_n runs per group of
_GROUP consecutive bands, each group normalized to its own max exponent,
and the groups are combined with per-entry factors exp(sig_g - S) <= 1
(the Gaunt mask guarantees n <= l + l' inside every surviving entry).
Same math as biem_helmholtz_sphere_tpu.translation._scaled.coaxial_scaled.
"""

from functools import lru_cache

import torch

from ..special._family import spherical_h_scaled
from ._ops import _a_const, ipow
from ._rotation import _coax_tables, _root_axis

# Bands per scale group: the within-group exponent spread (G-1) *
# ln(2N/(e k t)) stays inside the float32 exp range for k t > ~1e-4 N.
_GROUP = 8


@lru_cache(maxsize=4)
def _coax_bands(c, n_end, dtype, device):
    """Radius-independent band matrices U [NG, G, H, H] (real, zero-padded
    bands), exactly masked to the Gaunt support l + l' >= n''."""
    _, w, tz, t_cols, ell, _ = _coax_tables(c, n_end)
    kw = dict(dtype=dtype, device=device)
    tzw = torch.as_tensor(tz * w[:, None], **kw)  # [q, NB]
    tc = torch.as_tensor(t_cols, **kw)  # [q, H]
    h_num = tc.shape[1]
    n_bands = 2 * n_end - 1
    ng = -(-n_bands // _GROUP)
    u = torch.zeros(ng * _GROUP, h_num, h_num, **kw)
    lsum = torch.as_tensor(ell[:, None] + ell[None, :], device=device)
    for n in range(n_bands):
        u_n = (tc * tzw[:, n : n + 1]).T @ tc  # sum_q tz_n w T_a T_b
        u[n] = torch.where(lsum >= n, u_n, 0.0)
    return u.reshape(ng, _GROUP, h_num, h_num)


def coaxial_scaled(c, r, n_end, k):
    """(mant, S) coaxial (S|R) factor along the root axis.

    r: real tensor of radii [...]; k: real tensor broadcasting against r
    (e.g. [K, 1] against [NR]).  Returns complex mant [..., H, H] and
    real S [..., H, H].
    """
    _root_axis(c)
    d = c.c_ndim
    zf, _, _, _, ell, cs = _coax_tables(c, n_end)
    rdt, dev = r.dtype, r.device
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    u_g = _coax_bands(c, n_end, rdt, dev)  # [NG, G, H, H]
    ng, h_num = u_g.shape[0], u_g.shape[-1]
    n_bands = 2 * n_end - 1
    pad = ng * _GROUP - n_bands

    radm, rade = spherical_h_scaled(d, n_bands, k * r)  # [..., NB]
    bands = torch.arange(n_bands, device=dev)
    coefm = ipow(bands, cdt, dev) * torch.as_tensor(
        _a_const(d) * zf, dtype=rdt, device=dev
    ) * radm
    coefm = torch.nn.functional.pad(coefm, (0, pad))
    rade = torch.cat([rade, rade[..., -1:].expand(*rade.shape[:-1], pad)], dim=-1)
    rade_g = rade.reshape(*rade.shape[:-1], ng, _GROUP)
    sig_g = rade_g.amax(dim=-1)  # [..., NG]
    coefm_g = coefm.reshape(rade_g.shape) * torch.exp(rade_g - sig_g[..., None])

    # S = rade[l + l'] and the group factors exp(sig_g - S) are constant on
    # (degree x degree) blocks: exponentiate the [.., L, L] degree table
    # and expand it to [H, H] by indexing with the root degree.  The clamp
    # keeps masked-out 0 * exp(huge) at 0.
    ell_t = torch.as_tensor(ell, device=dev)
    l_ar = torch.arange(n_end, device=dev)
    rade_ll = rade[..., l_ar[:, None] + l_ar[None, :]]  # [..., L, L]
    exp_small = torch.exp(
        torch.clamp(sig_g[..., None, None] - rade_ll[..., None, :, :], max=80.0)
    )  # [..., NG, L, L]
    s_mat = rade_ll[..., ell_t, :][..., ell_t]
    batch = coefm.shape[:-1]
    acc = torch.zeros(batch + (h_num, h_num), dtype=cdt, device=dev)
    for g in range(ng):
        cm = coefm_g[..., g, :].reshape(-1, _GROUP)
        u = u_g[g].reshape(_GROUP, -1)
        t_g = torch.complex(cm.real @ u, cm.imag @ u).reshape(acc.shape)
        scale_g = exp_small[..., g, :, :][..., ell_t, :][..., ell_t]
        acc += t_g * scale_g
    # i^{l'-l} phase is rank-1 separable: i^{l'} (row) x conj(i^{l}) (col)
    p = ipow(ell_t, cdt, dev)
    same_cs = torch.as_tensor(cs[:, None] == cs[None, :], device=dev)
    mant = torch.where(same_cs, (acc * p[:, None]) * p.conj()[None, :], 0.0)
    return mant, s_mat
