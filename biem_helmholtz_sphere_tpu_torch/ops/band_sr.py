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

`band_sr` runs the CUDA kernels of `csrc/band_sr.cu` on CUDA tensors,
per group of offsets KF (`band_f`: F_N at every node, once) and then KS,
and `_band_sr_plain` (one `torch.matmul` per pair of degree blocks) on CPU
tensors; with the exponents and the row and column exponents e_r, e_b it
writes the folded table mant exp(e_r[k, h'] + he[k, o, N] + e_b[k, h]).
It builds the (S|R) table of every tree not rooted at a 'b'/'bp' node, and
the "triplet" and n_end_add != n_end translations of the others.
"""

from dataclasses import dataclass
from itertools import groupby

import numpy as np
import torch

from . import kernels

_TILE = 16  # rows of an M-tile, all of one degree (csrc/band_sr.cu kTile)
_SLOT = 2  # M-tiles of a CTA's slot (kRows = 32 rows), of one degree
_COLS = 64  # columns of a CTA (kCols)
_PAD = 8  # the cached tables' column count is a multiple of this
_QPAD = 16  # F's node count is a multiple of this (the chunks: 8 or 16 nodes)
_QSUM = 256  # nodes summed apart before their partial sums join (kSumNodes)
_F_BYTES = 1 << 29  # the F scratch of one group of offsets, at most
_PLAIN_BYTES = 1 << 30  # the plain version's temporaries per block product
_CLAMP = 80.0  # the JAX package's clamp of the band exponent differences
# KF (csrc/band_sr.cu): the bands a thread accumulates at once (kFWidth),
# its threads a CTA (kFThreads) and nodes a thread (kFNodes)
_KF_WIDTH = 16
_KF_THREADS = 128
_KF_NODES = 2


def _degree_runs(n):
    """(degree, start, end) of each run of one degree in the ascending n."""
    edges = np.flatnonzero(np.diff(n)) + 1
    return tuple((int(n[a]), int(a), int(b)) for a, b in
                 zip(np.r_[0, edges], np.r_[edges, len(n)]))


def row_tiles(n_o):
    """The kernel's M-tiles: (first, end) rows, each degree block of the
    rows cut into pieces of at most _TILE rows, in order."""
    return [(r, min(r + _TILE, b)) for _, a, b in _degree_runs(n_o) for r in range(a, b, _TILE)]


def row_plan(n_o):
    """The kernel's slots [n, _SLOT, 2]: the M-tiles of each degree taken
    _SLOT at a time (the last slot of a degree may hold one; its empty tile
    is (end, end) of the slot's first)."""
    slots = []
    for _, tiles in groupby(row_tiles(n_o), key=lambda t: n_o[t[0]]):
        tiles = list(tiles)
        for i in range(0, len(tiles), _SLOT):
            slot = tiles[i:i + _SLOT]
            slots.append(slot + [(slot[-1][1], slot[-1][1])] * (_SLOT - len(slot)))
    return np.asarray(slots, dtype=np.int32).reshape(-1, _SLOT, 2)


def col_span(n_i):
    """The widest range of column degrees over the kernel's _COLS-column
    tiles, plus one: the N values a CTA stages F for (its slot's one degree
    plus its columns')."""
    starts = np.arange(0, len(n_i), _COLS)
    return int((n_i[np.minimum(starts + _COLS, len(n_i)) - 1] - n_i[starts]).max()) + 1


def _padded(y):
    """y [Q, H] in a zeroed [Q, H rounded up to _PAD] (the kernel's 16-byte
    copies need rows on 16-byte boundaries)."""
    h = y.shape[1]
    out = y.new_zeros((y.shape[0], -(-h // _PAD) * _PAD))
    out[:, :h] = y
    return out


@dataclass(frozen=True)
class BandTables:
    """The quadrature tables of one (tree, n_out, n_in, dtype, device).

    w [Q] and s_cart [d, Q] real (the weights and the unit nodes); yo_pad
    [Q, Hop] and yi_pad [Q, Hip] complex, Y_out(s_q) and Y_in(s_q) with
    their column count padded to a multiple of _PAD by zeros, one tensor
    when n_out == n_in (the rows' conj is taken where they are read); yo
    [Q, Ho] and yi [Q, Hi] their views of the unpadded width (the plain
    version's, one view for both when n_out == n_in); n_o [Ho], n_i [Hi]
    int32 root degrees (ascending), with their host copies; plan int32
    [n, _SLOT, 2], the kernel's slots (`row_plan`).
    """

    w: torch.Tensor
    s_cart: torch.Tensor
    yo: torch.Tensor
    yi: torch.Tensor
    yo_pad: torch.Tensor
    yi_pad: torch.Tensor
    n_o: torch.Tensor
    n_i: torch.Tensor
    plan: torch.Tensor
    n_o_host: np.ndarray
    n_i_host: np.ndarray

    @classmethod
    def build(cls, w, s_cart, yo, yi, n_o, n_i):
        """From the tables on their device and the host degree vectors."""
        i32 = dict(dtype=torch.int32, device=w.device)
        yo_pad = _padded(yo)
        yi_pad = yo_pad if yi is yo else _padded(yi)
        yo = yo_pad[:, :yo.shape[1]]
        yi = yo if yi_pad is yo_pad else yi_pad[:, :yi.shape[1]]
        return cls(w, s_cart, yo, yi, yo_pad, yi_pad, torch.as_tensor(n_o, **i32),
                   torch.as_tensor(n_i, **i32), torch.as_tensor(row_plan(n_o), **i32), n_o, n_i)

    @property
    def n_bands(self):
        """The bands n'' = 0 .. max n' + max n."""
        return int(self.n_o_host[-1] + self.n_i_host[-1]) + 1

    @property
    def w_max(self):
        """The N values a CTA stages F for, at most (`col_span`)."""
        return col_span(self.n_i_host)

    @property
    def q_pad(self):
        """F's node count: Q rounded up to _QPAD."""
        return -(-self.w.shape[0] // _QPAD) * _QPAD

    @property
    def blocks(self):
        """((degree, start, end) of each degree block of the rows, and of
        the columns): the plain version's products."""
        return _degree_runs(self.n_o_host), _degree_runs(self.n_i_host)


def offset_groups(n_ko, q_pad, n_b, itemsize):
    """The (first, end) of each group of the K NO flattened offsets whose F
    scratch [G, n_b, q_pad] of `itemsize`-byte complex values fits _F_BYTES
    (at least one offset a group), in order and of sizes that differ by at
    most one."""
    per = q_pad * n_b * itemsize
    size = max(1, _F_BYTES // per)
    n_g = -(-n_ko // size)
    edges = [n_ko * i // n_g for i in range(n_g + 1)]
    return list(zip(edges[:-1], edges[1:]))


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


def _band_f_plain(coef, t_hat, tab, ko0, ko1):
    """Plain version of KF (and its CPU path): F [ko1 - ko0, NB, q_pad] of
    the flattened offsets ko0 .. ko1 - 1, formed as `_band_sr_plain` forms
    its f (zero past Q)."""
    n_k, n_off, n_b, _ = coef.shape
    d = t_hat.shape[-1]
    coef = coef.reshape(n_k * n_off, n_b, n_b)[ko0:ko1]
    t_hat = t_hat.expand(n_k, n_off, d).reshape(n_k * n_off, d)[ko0:ko1]
    x = torch.matmul(t_hat, tab.s_cart)  # [G, Q]
    cz = _gegenbauer(x, n_b - 1, 0.5 * (d - 2.0))  # [G, Q, NB]
    f = torch.matmul(cz.to(coef.dtype), coef.transpose(-1, -2)) * tab.w[:, None]
    return torch.nn.functional.pad(f.transpose(-1, -2), (0, tab.q_pad - tab.w.shape[0]))


def kf_chunks(n_b, width):
    """KF's chunks of bands, as the kernel cuts them: (N0, lo, hi) each,
    with N0 .. N0 + width - 1 the bands a thread accumulates and lo .. hi -
    1 those it stores.  The last chunk starts at n_b - width, so that it is
    full, and recomputes the bands it shares with the one before without
    storing them; the stored ranges cover 0 .. n_b - 1 once, in order."""
    return [(min(c * width, n_b - width) if n_b > width else 0, c * width,
             min((c + 1) * width, n_b)) for c in range(-(-n_b // width))]


def kf_nodes(q_pad, dtype):
    """The node of each (CTA, warp, lane, i) of KF's grid, int [ceil(q_pad /
    256), 4, 32, 2] (a node at or past q_pad is not stored): in complex64 a
    lane's two adjacent nodes (one 16-byte store of both), in complex128
    lanes l and l + 32 of its warp's 64 nodes (each store 32 consecutive
    nodes)."""
    warps = _KF_THREADS // 32
    tile = 32 * warps * _KF_NODES
    base = (np.arange(-(-q_pad // tile))[:, None, None, None] * tile
            + np.arange(warps)[None, :, None, None] * 32 * _KF_NODES)
    lane = np.arange(32)[None, None, :, None]
    i = np.arange(_KF_NODES)[None, None, None, :]
    if dtype == torch.complex64:
        return base + _KF_NODES * lane + i
    return base + 32 * i + lane


def band_f(coef, t_hat, tab, ko0, ko1, out=None):
    """KF wrapper: F [ko1 - ko0, NB, q_pad], F_N at every node for the
    flattened offsets ko0 .. ko1 - 1 (zero past Q); arguments as `band_sr`,
    coef and t_hat contiguous.  On CPU tensors the plain version; on CUDA
    tensors it launches csrc/band_sr.cu's KF (a CTA per offset and tile of
    256 nodes, `kf_nodes`; the bands in chunks of _KF_WIDTH, `kf_chunks`),
    into `out` (a scratch of at least ko1 - ko0 leading rows) when given,
    or raises."""
    if coef.device.type == "cpu":
        return _band_f_plain(coef, t_hat, tab, ko0, ko1)
    n_k, n_off, n_b, _ = coef.shape
    d = t_hat.shape[-1]
    g = ko1 - ko0
    if out is None:
        out = torch.empty((g, n_b, tab.q_pad), dtype=coef.dtype, device=coef.device)
    if (not coef.is_contiguous() or not t_hat.is_contiguous() or not 0 <= ko0 < ko1 <= n_k * n_off
            or out.shape[0] < g or out.shape[1:] != (n_b, tab.q_pad) or not out.is_contiguous()
            or out.dtype != coef.dtype):
        raise ValueError(f"band_f: offsets [{ko0}, {ko1}) of {n_k * n_off}, scratch "
                         f"{tuple(out.shape)} {out.dtype}, coef {coef.dtype}")
    kernels.launch(
        "bhs_band_f", coef, t_hat, n_off * d if t_hat.shape[0] > 1 else 0, tab.w, tab.s_cart,
        out, ko0, g, n_off, d, tab.w.shape[0], tab.q_pad, n_b, 0.5 * (d - 2.0),
        int(coef.dtype == torch.complex128),
    )
    band_f.launches += 1
    return out[:g]


band_f.launches = 0


def band_sr(coef, t_hat, tab, he=None, e_r=None, e_b=None):
    """KS wrapper: the banded table [K, NO, Ho, Hi] (with the i-power).

    coef: complex [K, NO, NB, NB] (`band_coefs`), NB = tab.n_bands; t_hat:
    real [K, NO, d] unit offsets, or [1, NO, d] (one geometry: read at k
    stride 0); tab: the BandTables.  Fold mode: he [K, NO, NB] the band
    exponents, e_r [K, Ho] and e_b [K, Hi] the row and column exponents,
    folded in as exp(e_r + he[N] + e_b); else all three None.  On CPU
    tensors this runs the plain version; on CUDA tensors it launches
    csrc/band_sr.cu, KF then KS for each group of offsets
    (`offset_groups`), or raises.
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
    coef, t_hat = coef.contiguous(), t_hat.contiguous()
    if fold:
        he, e_r, e_b = he.contiguous(), e_r.contiguous(), e_b.contiguous()
    out = torch.empty((n_k, n_off, h_out, h_in), dtype=cdt, device=coef.device)
    groups = offset_groups(n_k * n_off, tab.q_pad, n_b, coef.element_size())
    scratch = torch.empty((max(b - a for a, b in groups), n_b, tab.q_pad), dtype=cdt,
                          device=coef.device)
    for ko0, ko1 in groups:
        f = band_f(coef, t_hat, tab, ko0, ko1, scratch)
        kernels.launch(
            "bhs_band_sr", f, tab.yo_pad, tab.yi_pad, tab.n_o, tab.n_i, tab.plan,
            he if fold else 0, e_r if fold else 0, e_b if fold else 0, out, ko0, ko1 - ko0,
            n_off, tab.w.shape[0], tab.q_pad, h_out, h_in, tab.yo_pad.shape[1],
            tab.yi_pad.shape[1], n_b, tab.plan.shape[0], tab.w_max, int(fold),
            int(cdt == torch.complex128),
        )
        band_sr.launches += 1
    return out


band_sr.launches = 0
