r"""KS: the banded (S|R) (or (R|R)) table of any tree in d >= 3.

For an offset t = |t| t^ and the tree's product quadrature (s_q, w_q), the
JAX package's masked band scan (biem_helmholtz_sphere_tpu/translation/
_ops.py::_sr_banded, and _scaled.py::sr_banded_scaled with per-band
exponents; once the Pallas kernel ops/pallas_sr.py::sr_banded_pallas)
computes

    M[h', h] = i^{n' - n} sum_{n'' <= n' + n} sum_q c_{n''} Z_{n''}(t^.s_q) w_q
               conj(Y_{h'}(s_q)) Y_h(s_q)

with c_{n''} = i^{n''} A_d rad_{n''}(k |t|) (h for (S|R), j for (R|R)) and
Z_{n''} = (2n'' + d - 2) / ((d - 2) Omega_d) C^{nu}_{n''}, nu = (d - 2) / 2,
the zonal kernel.  The mask depends on (h', h) only through N = n' + n, so
the sum over the bands is the contraction of the prefix

    F_N(q) = w_q sum_{n'' <= N} coef[N, n''] C^{nu}_{n''}(t^.s_q)

with coef[N, n''] = c_{n''} (2n'' + d - 2) / ((d - 2) Omega_d), times
exp(min(he_{n''} - he_N, 80)) when rad carries exponents he (the scaled
modes: the mantissa of SR = mant exp(he_N)).  Each entry still meets only the
bands at or below its own Gaunt support, as in the masked scan, and costs
one complex product per node instead of one per band.

`band_sr` runs the CUDA kernel `csrc/band_sr.cu` on CUDA tensors and
`_band_sr_plain` (one `torch.matmul` per pair of degree blocks) on CPU
tensors; with the exponents and the row and column exponents e_r, e_b it
writes the folded table mant exp(e_r[k, h'] + he[k, o, N] + e_b[k, h]).
It builds the (S|R) table of every tree not rooted at a 'b'/'bp' node, and
the "triplet" and n_end_add != n_end translations of the others.
"""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from . import kernels

_ROWS = 32  # the rows of a CTA's tile, all of one degree (csrc/band_sr.cu kRows)
_COLS = 128  # the columns of a CTA's tile (kCols)
_QC = 32  # quadrature nodes per chunk (kQc)
_QSUM = 256  # nodes summed apart before their partial sums join (kQc kGroup)
_SMEM = 232448  # the H100's shared memory per block
_PLAIN_BYTES = 1 << 30  # the plain version's temporaries per block product
_CLAMP = 80.0  # the JAX package's clamp of the band exponent differences


def _degree_runs(n):
    """(degree, start, end) of each run of one degree in the ascending n."""
    edges = np.flatnonzero(np.diff(n)) + 1
    return tuple((int(n[a]), int(a), int(b)) for a, b in
                 zip(np.r_[0, edges], np.r_[edges, len(n)]))


@dataclass(frozen=True)
class BandTables:
    """The quadrature tables of one (tree, n_out, n_in, dtype, device).

    w [Q] and s_cart [d, Q] real (the weights and the unit nodes); yo
    [Q, Ho] = Y_out(s_q) and yi [Q, Hi] = Y_in(s_q) complex, one tensor
    when n_out == n_in (the rows' conj is taken where they are read); n_o
    [Ho], n_i [Hi] int32 root degrees (ascending), with their host copies;
    row_tiles int32 [n, 2], the kernel's row tiles (first, end): each
    degree block of the rows cut into pieces of at most _ROWS.
    """

    w: torch.Tensor
    s_cart: torch.Tensor
    yo: torch.Tensor
    yi: torch.Tensor
    n_o: torch.Tensor
    n_i: torch.Tensor
    row_tiles: torch.Tensor
    n_o_host: np.ndarray
    n_i_host: np.ndarray

    @classmethod
    def build(cls, w, s_cart, yo, yi, n_o, n_i):
        """From the tables on their device and the host degree vectors."""
        i32 = dict(dtype=torch.int32, device=w.device)
        tiles = [(r, min(r + _ROWS, b)) for _, a, b in _degree_runs(n_o)
                 for r in range(a, b, _ROWS)]
        return cls(w, s_cart, yo, yi, torch.as_tensor(n_o, **i32),
                   torch.as_tensor(n_i, **i32), torch.as_tensor(tiles, **i32), n_o, n_i)

    @property
    def n_bands(self):
        """The bands n'' = 0 .. max n' + max n."""
        return int(self.n_o_host[-1] + self.n_i_host[-1]) + 1

    @cached_property
    def w_max(self):
        """The widest range of N = n' + n over the kernel's tiles: the
        degree span of _COLS columns (a tile's rows share one degree)."""
        n = self.n_i_host
        starts = np.arange(0, len(n), _COLS)
        return int((n[np.minimum(starts + _COLS, len(n)) - 1] - n[starts]).max()) + 1

    @cached_property
    def blocks(self):
        """((degree, start, end) of each degree block of the rows, and of
        the columns): the plain version's products."""
        return _degree_runs(self.n_o_host), _degree_runs(self.n_i_host)


def band_coefs(rad, d, omega, a_d, he=None):
    """coef [..., NB, NB] of the prefix F_N (see the module docstring).

    rad: complex [..., NB], rad_n(k |t|) or its mantissas; he: real
    [..., NB] exponents or None (unscaled).  coef[..., N, n] is zero for
    n > N.
    """
    n_b = rad.shape[-1]
    dev = rad.device
    n = torch.arange(n_b, device=dev)
    units = torch.tensor([1, 1j, -1, -1j], dtype=rad.dtype, device=dev)
    zfac = torch.as_tensor((2.0 * np.arange(n_b) + d - 2.0) / ((d - 2.0) * omega) * a_d,
                           dtype=rad.real.dtype, device=dev)
    c = units[n % 4] * zfac * rad  # [..., NB]
    mask = n[None, :] <= n[:, None]  # [N, n]
    if he is None:
        return torch.where(mask, c[..., None, :], 0.0)
    scale = torch.exp(torch.clamp(he[..., None, :] - he[..., :, None], max=_CLAMP))
    return torch.where(mask, c[..., None, :] * scale, 0.0)


def _gegenbauer(x, n_max, nu):
    """C^{nu}_n(x) for n = 0..n_max: [..., n_max + 1], by the three-term
    recurrence (n + 1) C_{n+1} = 2 (n + nu) x C_n - (n + 2 nu - 1) C_{n-1}."""
    out = [torch.ones_like(x)]
    cm, cc = torch.zeros_like(x), out[0]
    for n in range(n_max):
        cn = (2.0 * (n + nu) * x * cc - (n + 2.0 * nu - 1.0) * cm) / (n + 1.0)
        cm, cc = cc, cn
        out.append(cn)
    return torch.stack(out, dim=-1)


def _band_sr_plain(coef, t_hat, tab, he=None, e_r=None, e_b=None):
    """Plain version of the KS kernel (and its CPU path); arguments as
    `band_sr`.  One batched [., |A|, Q] x [Q, |B|] product per pair of
    degree blocks (A, B), with F_{deg A + deg B} on the rows' side, over
    chunks of _QSUM nodes whose partial sums are then summed, as the kernel
    does (a product over all Q nodes at once may sum them in one sequence,
    which in float32 loses ~1e-4 of the small blocks); (k, o) pairs a few
    at a time, within ~_PLAIN_BYTES of temporaries."""
    n_k, n_off, n_b, _ = coef.shape
    d = t_hat.shape[-1]
    n_q = tab.w.shape[0]
    n_c = -(-n_q // _QSUM)
    pad = (0, 0, 0, n_c * _QSUM - n_q)
    yo, yi = (torch.nn.functional.pad(t, pad) for t in (tab.yo, tab.yi))
    h_out, h_in = yo.shape[1], yi.shape[1]
    rows, cols = tab.blocks
    widest = max(b - a for _, a, b in rows)
    step = max(1, _PLAIN_BYTES // (n_c * _QSUM * widest * coef.element_size()))
    coef = coef.reshape(n_k * n_off, n_b, n_b)
    t_hat = t_hat.expand(n_k, n_off, d).reshape(n_k * n_off, d)
    out = coef.new_empty((n_k * n_off, h_out, h_in))
    yi_c = [yi[:, ca:cb].reshape(n_c, _QSUM, cb - ca) for _, ca, cb in cols]
    for p0 in range(0, n_k * n_off, step):
        p1 = min(p0 + step, n_k * n_off)
        x = torch.matmul(t_hat[p0:p1], tab.s_cart)  # [P, Q]
        cz = _gegenbauer(x, n_b - 1, 0.5 * (d - 2.0))  # [P, Q, NB]
        f = torch.matmul(cz.to(coef.dtype), coef[p0:p1].transpose(-1, -2))  # [P, Q, N]
        f = torch.nn.functional.pad(f * tab.w[:, None], pad)
        for na, ra, rb in rows:
            for (nb, ca, cb), yb in zip(cols, yi_c):
                g = yo[:, ra:rb].conj() * f[..., na + nb, None]  # [P, Q, |A|]
                g = g.reshape(p1 - p0, n_c, _QSUM, rb - ra).transpose(-1, -2)
                out[p0:p1, ra:rb, ca:cb] = (g @ yb).sum(dim=-3)
    units = torch.tensor([1, 1j, -1, -1j], dtype=coef.dtype, device=coef.device)
    n_o, n_i = tab.n_o.long(), tab.n_i.long()
    out = out.reshape(n_k, n_off, h_out, h_in) * units[(n_o[:, None] - n_i[None, :]) % 4]
    if he is None:
        return out
    return out * torch.exp(e_r[:, None, :, None] + he[..., n_o[:, None] + n_i[None, :]]
                           + e_b[:, None, None, :])


def band_sr(coef, t_hat, tab, he=None, e_r=None, e_b=None):
    """KS wrapper: the banded table [K, NO, Ho, Hi] (with the i-power).

    coef: complex [K, NO, NB, NB] (`band_coefs`), NB = tab.n_bands; t_hat:
    real [K, NO, d] unit offsets, or [1, NO, d] (one geometry: read at k
    stride 0); tab: the BandTables.  Fold mode: he [K, NO, NB] the band
    exponents, e_r [K, Ho] and e_b [K, Hi] the row and column exponents,
    folded in as exp(e_r + he[N] + e_b); else all three None.  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/band_sr.cu or raises.
    """
    n_k, n_off, n_b, n_b2 = coef.shape
    h_out, h_in = tab.yo.shape[1], tab.yi.shape[1]
    fold = he is not None
    d = t_hat.shape[-1]
    if (n_b != n_b2 or n_b != tab.n_bands or fold != (e_r is not None)
            or fold != (e_b is not None)
            or t_hat.shape[:2] not in ((n_k, n_off), (1, n_off)) or d != tab.s_cart.shape[0]
            or (fold and (he.shape != (n_k, n_off, n_b) or e_r.shape != (n_k, h_out)
                          or e_b.shape != (n_k, h_in)))):
        raise ValueError(
            f"band_sr: coef {tuple(coef.shape)}, t_hat {tuple(t_hat.shape)}, tables "
            f"({tab.n_bands} bands, d={tab.s_cart.shape[0]}, Ho={h_out}, Hi={h_in}), he, "
            f"e_r, e_b {[None if t is None else tuple(t.shape) for t in (he, e_r, e_b)]} "
            "do not match"
        )
    if coef.device.type == "cpu":
        return _band_sr_plain(coef, t_hat, tab, he, e_r, e_b)
    if coef.device.type != "cuda":
        raise RuntimeError(f"band_sr: unsupported device {coef.device}")
    cdt = coef.dtype
    rdt = kernels.REAL_OF.get(cdt)
    reals = (t_hat, tab.w, tab.s_cart) + ((he, e_r, e_b) if fold else ())
    if (rdt is None or any(t.dtype != rdt for t in reals) or tab.yo.dtype != cdt
            or tab.yi.dtype != cdt):
        raise TypeError(
            f"band_sr: dtypes coef {cdt}, t_hat {t_hat.dtype}, tables {tab.yo.dtype}"
            + (f", he {he.dtype}, e_r {e_r.dtype}, e_b {e_b.dtype}" if fold else "")
        )
    csize = coef.element_size()
    smem = _QC * (_ROWS + _COLS + tab.w_max) * csize + _QC * n_b * csize // 2
    if smem > _SMEM:
        raise ValueError(f"band_sr: {n_b} bands need {smem} bytes of shared memory")
    coef, t_hat = coef.contiguous(), t_hat.contiguous()
    if fold:
        he, e_r, e_b = he.contiguous(), e_r.contiguous(), e_b.contiguous()
    out = torch.empty((n_k, n_off, h_out, h_in), dtype=cdt, device=coef.device)
    kernels.launch(
        "bhs_band_sr", coef, he if fold else 0, t_hat, n_off * d if t_hat.shape[0] > 1 else 0,
        tab.w, tab.s_cart, tab.yo, tab.yi, tab.n_o, tab.n_i, tab.row_tiles,
        e_r if fold else 0, e_b if fold else 0, out, n_k, n_off, d, tab.w.shape[0], h_out,
        h_in, n_b, tab.row_tiles.shape[0], tab.w_max, 0.5 * (d - 2.0), int(fold),
        int(cdt == torch.complex128),
    )
    band_sr.launches += 1
    return out


band_sr.launches = 0
