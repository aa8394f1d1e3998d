r"""Scale-compensated coaxial (S|R) factor: mantissa + per-entry exponent.

The (S|R) entries scale like |h_{l+l'}(k t)|, which overflows float32
from n_end ~ k t + 20.  `coaxial_scaled` returns the coaxial factor as
(mant, S): SR_e = mant * exp(S), with S[h', h] = log|h_{l+l'}(kr)| and
|mant| ~ O(1).  The band contraction sum_n coef_n U_n runs per group of
_GROUP consecutive bands, each group normalized to its own max exponent,
and the groups are combined with per-entry factors exp(sig_g - S) <= 1
(the Gaunt mask guarantees n <= l + l' inside every surviving entry).
Same math as biem_helmholtz_sphere_tpu.translation._scaled.coaxial_scaled.

K2: the factored operator needs the coaxial factor only folded with the
ball-max radial exponents and packed into its child-state blocks.
`coax_fold_packed` computes exactly those values: on CUDA tensors one
launch of `csrc/coax_fold.cu` after the K5 launch for h_n(k r), on CPU
tensors `_coax_fold_packed_plain`.  Its radius-independent bands are kept
at the packed entries only ([NG * G, nnz], 2.1% of the dense [NB, H, H]
at n_end=32), and for the kernel also as tiles of _TILE entries of one
top group (l + l') // _GROUP, each with only the bands below its top
group's end (`_coax_tiles` plans them on the host from the entries'
degrees).  KU (`ops/coax_u.py`, one launch on the card) forms both from
the root tables built on the device.  `coaxial_scaled` keeps the dense
(mant, S) for the translation surface.

2D (Graf's closed form): the entries ARE gathered radial values, so
`graf_2d_scaled` gathers (mantissa, exponent) of h_{|m - m'|}(k|t|) from
K5's d = 2 family; S then depends on |m - m'| and is not constant on
degree blocks.  `graf_2d_folded` is the table the BIEM routes use, with
the ball-max exponents folded in: one K5 launch and one KG launch
(ops/graf.py) on CUDA tensors.

Trees not rooted at a 'b'/'bp' node (the 'c' roots): the band scan with
per-band exponents, S[h', h] = he[n' + n] (`sr_banded_scaled`), and with
the ball-max exponents folded in (`sr_banded_folded`): one K5 launch and
one KS launch (ops/band_sr.py) on CUDA tensors.
"""

from dataclasses import dataclass, replace
from functools import cached_property, lru_cache

import numpy as np
import torch

from ..ops import kernels
from ..ops.band_sr import band_coefs, band_sr
from ..ops.block_diag import BlockDiag, pack_layout
from ..ops.coax_u import _GROUP, _TILE, _CoaxPlan, coax_u
from ..ops.graf import graf_fold, graf_gather
from ..special._family import spherical_h_scaled
from ._ops import (_a_const, _a_node_m, _a_node_m_on, _band_consts, _band_inputs,
                   _polar_offsets, _quad_tables, _unit_offsets, ipow)
from ._rotation import _coax_index, _coax_tables_on, _offsets_of, _root_axis, _sandwich

# Bands per scale group, _GROUP (ops/coax_u.py): the within-group exponent
# spread (G-1) * ln(2N/(e k t)) stays inside the float32 exp range for
# k t > ~1e-4 N.  Packed entries per tile of the K2 and KU kernels, _TILE;
# the most U slabs (groups of _GROUP bands of a tile) a K2 work unit holds:
_UNIT_SLABS = 24
# A tile's cost in the K2 kernel beside its slabs' (its entries, phases,
# fold factors and stores), in slabs: tools/torch_k2_trace.py on an H100
_TILE_COST = 2.56


def _band_groups(radm, rade, iazf, ng):
    """The band coefficients i^n a_d zf_n radm_n in ng groups of _GROUP,
    each scaled to its largest exponent: (coefm_g [..., NG, G], sig_g
    [..., NG], rade [..., NG * G] padded with its last value)."""
    pad = ng * _GROUP - radm.shape[-1]
    coefm = torch.nn.functional.pad(iazf * radm, (0, pad))
    rade = torch.cat([rade, rade[..., -1:].expand(*rade.shape[:-1], pad)], dim=-1)
    rade_g = rade.reshape(*rade.shape[:-1], ng, _GROUP)
    sig_g = rade_g.amax(dim=-1)
    return coefm.reshape(rade_g.shape) * torch.exp(rade_g - sig_g[..., None]), sig_g, rade


@lru_cache(maxsize=4)
def _coax_bands(c, n_end, dtype, device):
    """Radius-independent band matrices U [NG, G, H, H] (real, zero-padded
    bands), exactly masked to the Gaunt support l + l' >= n'': each band
    formed in float64 from the root tables on `device` and rounded once."""
    ell = _coax_index(c, n_end)[3]
    t, tzw = _coax_tables_on(c, n_end, torch.device(device))  # [H, q], [q, NB]
    h_num, n_bands = t.shape[0], tzw.shape[1]
    ng = -(-n_bands // _GROUP)
    u = torch.zeros(ng * _GROUP, h_num, h_num, dtype=dtype, device=device)
    lsum = torch.as_tensor(ell[:, None] + ell[None, :], device=device)
    for n in range(n_bands):
        u[n] = torch.where(lsum >= n, (t * tzw[:, n]) @ t.T, 0.0)  # sum_q tz_n w T_a T_b
    return u.reshape(ng, _GROUP, h_num, h_num)


def coaxial_scaled(c, r, n_end, k):
    """(mant, S) coaxial (S|R) factor along the root axis.

    r: real tensor of radii [...]; k: real or complex tensor broadcasting
    against r (e.g. [K, 1] against [NR]).  Returns complex mant [..., H, H] and
    real S [..., H, H].
    """
    _root_axis(c)
    d = c.c_ndim
    zf, _, _, ell, cs = _coax_index(c, n_end)
    rdt, dev = r.dtype, r.device
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    u_g = _coax_bands(c, n_end, rdt, dev)  # [NG, G, H, H]
    ng, h_num = u_g.shape[0], u_g.shape[-1]
    n_bands = 2 * n_end - 1

    radm, rade = spherical_h_scaled(d, n_bands, k * r)  # [..., NB]
    iazf = ipow(torch.arange(n_bands, device=dev), cdt, dev) * torch.as_tensor(
        _a_const(d) * zf, dtype=rdt, device=dev
    )
    coefm_g, sig_g, rade = _band_groups(radm, rade, iazf, ng)

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
    batch = coefm_g.shape[:-2]
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


@lru_cache(maxsize=8)
def _child_state_blocks(c, n_end):
    """(sizes, perm) of the coaxial factor's blocks: the harmonics of each
    child state (the order m on "ba"), in basis order, made contiguous."""
    cs = _coax_index(c, n_end)[4]
    return np.bincount(cs), np.argsort(cs, kind="stable")


@dataclass(frozen=True)
class CoaxPacked:
    """Radius-independent tables of the packed coaxial factor."""

    layout: BlockDiag  # the child-state blocks (vals=None)
    u: torch.Tensor  # real [NG * G, nnz] bands at the packed entries
    iazf: torch.Tensor  # complex [NB] i^n a_d zf_n
    l_row: torch.Tensor  # int32 [nnz] root degree of each packed row
    l_col: torch.Tensor  # int32 [nnz] root degree of each packed column
    order: torch.Tensor  # int32 [nnz, 2] (packed index, l_row + 65536 l_col) by top group
    units: torch.Tensor  # int32 [n_units, 4] (first entry of order, entries, top group, slab)
    u_tiles: torch.Tensor  # real [slabs, 2, _TILE, 4] the tiles' bands, slab by slab
    unit_slabs: int  # the most slabs of a unit

    @cached_property
    def kernel_tables(self):
        """The K2 kernel's scalar table arguments, fixed for the tables'
        life: (ng, nnz, n_units, the most slabs of a unit, float64 flag)."""
        return (self.u.shape[0] // _GROUP, self.u.shape[1], self.units.shape[0],
                self.unit_slabs, int(self.u.dtype == torch.float64))


def _coax_tiles(lsum, n_sm):
    """The K2 kernel's tiles and work units of the packed entries (host
    numpy, from their degrees: no loop over tiles or units).

    lsum [nnz] l + l' of each packed entry; n_sm the card's
    multiprocessors.  Entries are ordered by top group lsum // _GROUP,
    largest first (stable), and each run of one top group is cut into
    tiles of _TILE (the run's last one ragged).  A tile of top group g holds
    its bands 0 .. G (g + 1) - 1 as g + 1 slabs of the image (KU fills it,
    `ops/coax_u.py`).  Each run is dealt out in work units of consecutive
    tiles (counts differing by at most one), at most _UNIT_SLABS slabs a
    unit where a tile fits, and the runs' unit counts grow, the run with
    the costliest unit first (a tile costs its slabs and _TILE_COST), until
    there are n_sm units.  Bands above lsum are zero in u (the Gaunt mask),
    so no entry needs a group above its top.

    Returns (order [nnz], units [n_units, 4] = (first entry of order,
    entries, top group, first slab), tiles [n_tiles, 4] = (first entry of
    order, entries, top group, slab), the image's slabs, the most slabs of
    a unit).
    """
    top = lsum // _GROUP
    order = np.argsort(-top, kind="stable")
    cuts = np.flatnonzero(np.diff(top[order])) + 1
    start, stop = np.r_[0, cuts], np.r_[cuts, len(order)]
    g = top[order[start]]
    n_tiles = -(-(stop - start) // _TILE)
    size = g + 1  # slabs per tile
    n_units = -(-n_tiles // np.maximum(1, _UNIT_SLABS // size))
    while n_units.sum() < n_sm:  # one unit more a step, at most n_sm steps
        # the cost of each run's largest unit, of the runs that can be cut further
        cost = np.where(n_units < n_tiles, -(-n_tiles // n_units) * (size + _TILE_COST), -1.0)
        if cost.max() < 0:
            break
        n_units[int(np.argmax(cost))] += 1

    def ranks(counts):  # (run of each item, its index within the run)
        run = np.repeat(np.arange(len(counts)), counts)
        return run, np.arange(len(run)) - np.repeat(np.cumsum(counts) - counts, counts)

    run, i = ranks(n_units)
    k, n = n_units[run], n_tiles[run]
    unit_tiles = n // k + (i < n % k)  # tiles of each unit
    t0 = np.cumsum(unit_tiles) - unit_tiles  # first tile, counted from the first run's
    t0 -= t0[np.cumsum(n_units) - n_units][run]
    e0 = start[run] + t0 * _TILE
    e1 = np.minimum(stop[run], e0 + unit_tiles * _TILE)
    unit_slabs = unit_tiles * size[run]
    units = np.stack([e0, e1 - e0, g[run], np.cumsum(unit_slabs) - unit_slabs], axis=1)
    run, i = ranks(n_tiles)
    t_start = start[run] + i * _TILE
    t_slabs = size[run]
    tiles = np.stack([t_start, np.minimum(_TILE, stop[run] - t_start), g[run],
                      np.cumsum(t_slabs) - t_slabs], axis=1)
    return order, units, tiles, int(t_slabs.sum()), int(unit_slabs.max())


def _coax_packed(c, n_end, dtype, device):
    """CoaxPacked for (tree, n_end) in real dtype on device (a bare "cuda"
    is the current card: the tables live there, sized by its SM count).

    U_n[a, b] = sum_q t[q, a] tz[q, n] w[q] t[q, b], masked to the Gaunt
    support l_a + l_b >= n, is formed at the packed (a, b) only, in float64,
    by KU (`ops/coax_u.py`) from the root tables built on the device; bands
    are zero-padded to whole groups of _GROUP.  The host builds only the
    index vectors and the tile plan (`_coax_tiles`); the K2 kernel reads U
    as the plan lays it out.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _coax_packed_on(c, n_end, dtype, device)


def _layout_on(lay, device):
    """The BlockDiag layout `lay` with its index tensors on `device`."""
    return replace(lay, **{f: getattr(lay, f).to(device) for f in
                           ("offs", "sizes", "voffs", "rows", "cols", "perm")
                           if getattr(lay, f) is not None})


@lru_cache(maxsize=4)
def _coax_plan_on(c, n_end, device):
    """The host's share of the packed coaxial tables, on `device`: (layout
    of the child-state blocks, KU's plan, K2's units, the most slabs of a
    unit, l_row [nnz], l_col [nnz]), from the index vectors and the tile
    plan (`_coax_tiles`), cached per (tree, n_end, device)."""
    ell = _coax_index(c, n_end)[3]
    host = pack_layout(*_child_state_blocks(c, n_end), len(ell), "cpu")
    rows, cols = host.rows.numpy(), host.cols.numpy()
    n_sm = 132  # the H100's; the card's own where the tables live on one
    if device.type == "cuda":
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    order, units, tiles, slabs, unit_slabs = _coax_tiles(ell[rows] + ell[cols], n_sm)
    l_pair = ell[rows] + 65536 * ell[cols]
    i32 = dict(dtype=torch.int32, device=device)
    plan = _CoaxPlan(order=torch.as_tensor(np.stack([order, l_pair[order]], axis=1), **i32),
                     tiles=torch.as_tensor(tiles, **i32), slabs=slabs,
                     ng=-(-(2 * n_end - 1) // _GROUP))
    return (_layout_on(host, device), plan, torch.as_tensor(units, **i32), unit_slabs,
            torch.as_tensor(ell[rows], **i32), torch.as_tensor(ell[cols], **i32))


@lru_cache(maxsize=4)
def _coax_packed_on(c, n_end, dtype, device):
    layout, plan, units, unit_slabs, l_row, l_col = _coax_plan_on(c, n_end, device)
    u, u_tiles = coax_u(_coax_tables_on(c, n_end, device), layout, plan, dtype)
    n_bands = 2 * n_end - 1
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    iazf = ipow(np.arange(n_bands), cdt, device) * torch.as_tensor(
        _a_const(c.c_ndim) * _coax_index(c, n_end)[0], dtype=dtype, device=device
    )
    return CoaxPacked(layout=layout, u=u, iazf=iazf, l_row=l_row, l_col=l_col,
                      order=plan.order, units=units, u_tiles=u_tiles, unit_slabs=unit_slabs)


def _coax_fold_packed_plain(radm, rade, e_r, e_b, tab):
    """Plain version of the K2 kernel (and its CPU path).

    radm, rade [K, NR, NB]: scaled h_n(k r) of the bands; e_r, e_b [K, L]:
    degree-level ball-max radial exponents.  Returns the packed folded
    coaxial values [K, NR, nnz]: the same operations, in the same order, as
    coaxial_scaled followed by the fold exp(e_r[l] + S + e_b[l']) of
    biem/_core.py, at the packed entries only.
    """
    n_k, n_rad, _ = radm.shape
    nbp, nnz = tab.u.shape
    coefm_g, sig_g, rade = _band_groups(radm, rade, tab.iazf, nbp // _GROUP)
    l_row, l_col = tab.l_row.long(), tab.l_col.long()
    rade_l = rade[..., l_row + l_col]  # S at the packed entries [K, NR, nnz]
    acc = torch.zeros((n_k, n_rad, nnz), dtype=radm.dtype, device=radm.device)
    for g in range(nbp // _GROUP):
        cm = coefm_g[..., g, :].reshape(-1, _GROUP)
        u = tab.u[g * _GROUP : (g + 1) * _GROUP]
        t_g = torch.complex(cm.real @ u, cm.imag @ u).reshape(acc.shape)
        acc += t_g * torch.exp(torch.clamp(sig_g[..., g, None] - rade_l, max=80.0))
    p_row = ipow(l_row, radm.dtype, radm.device)
    p_col = ipow(l_col, radm.dtype, radm.device)
    mant = (acc * p_row) * p_col.conj()
    factor = torch.exp(e_r[:, None, l_row] + rade_l + e_b[:, None, l_col])
    return mant * factor


def coax_fold(radm, rade, e_r, e_b, tab):
    """K2 wrapper: the packed folded coaxial values [K, NR, nnz].

    Arguments as `_coax_fold_packed_plain`.  On CPU tensors this runs the
    plain version; on CUDA tensors it launches csrc/coax_fold.cu or
    raises.
    """
    n_k, n_rad, n_bands = radm.shape
    if rade.shape != radm.shape or e_r.shape != e_b.shape or e_r.shape[0] != n_k:
        raise ValueError(
            f"coax_fold: radm {tuple(radm.shape)}, rade {tuple(rade.shape)}, "
            f"e_r {tuple(e_r.shape)}, e_b {tuple(e_b.shape)} do not match"
        )
    if radm.device.type == "cpu":
        return _coax_fold_packed_plain(radm, rade, e_r, e_b, tab)
    if radm.device.type != "cuda":
        raise RuntimeError(f"coax_fold: unsupported device {radm.device}")
    rdt = rade.dtype
    if radm.dtype != tab.iazf.dtype or rdt != tab.u.dtype or e_r.dtype != rdt:
        raise TypeError(
            f"coax_fold: dtypes radm {radm.dtype}, rade {rdt}, e_r {e_r.dtype}, "
            f"tables {tab.u.dtype}"
        )
    radm, rade = radm.contiguous(), rade.contiguous()
    e_r, e_b = e_r.contiguous(), e_b.contiguous()
    ng, nnz, n_units, unit_slabs, dbl = tab.kernel_tables
    out = torch.empty((n_k, n_rad, nnz), dtype=radm.dtype, device=radm.device)
    kernels.launch(
        "bhs_coax_fold", radm, rade, tab.iazf, tab.u_tiles, tab.units, tab.order, e_r, e_b,
        out, n_k * n_rad, n_rad, n_bands, ng, nnz, n_units, unit_slabs, e_r.shape[-1], dbl,
    )
    coax_fold.launches += 1
    return out


coax_fold.launches = 0


def coax_fold_packed(c, n_end, r, k, e_r, e_b):
    """The folded coaxial factor X of the factored operator, packed.

    r: real [NR] distinct pair distances (or [K, NR], each k's own);
    k: real or complex [K]; e_r, e_b [K, L]:
    degree-level ball-max exponents of the regular and combined-field
    radial rows.  Returns the BlockDiag of X = mant * exp(e_r[l] + S +
    e_b[l']) on the child-state blocks, vals [K, NR, nnz]: one K5 launch
    (h_n(k r) of the bands) and one K2 launch on CUDA tensors.
    """
    _root_axis(c)
    tab = _coax_packed(c, n_end, r.dtype, r.device)
    radm, rade = spherical_h_scaled(c.c_ndim, 2 * n_end - 1, k[:, None] * r)
    return replace(tab.layout, vals=coax_fold(radm, rade, e_r, e_b, tab))


def graf_2d_scaled(c, t_sph, n_out, k, kind="SR", t_cart=None):
    """(mant, S) of the 2D Graf closed form (see _ops._graf_2d): SR =
    mant * exp(S), [..., H, H] each, S[h', h] the exponent of
    h_{|m - m'|}(k|t|).  t by its spherical mapping or by cartesian t_cart
    [2, ...]; k real or complex, broadcasting against t's batch shape."""
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    r_t, theta = _polar_offsets(c, t_sph, t_cart)
    m = torch.as_tensor(_a_node_m(c, n_out), device=theta.device)
    hm, he = spherical_h_scaled(2, 2 * n_out - 1, k * r_t)  # |m - m'| < 2 n_end - 1
    return graf_gather(hm, theta, m, m, he)


def graf_2d_folded(c, t_cart, n_end, k, e_r, e_b):
    """The 2D (S|R) table with the row and column exponents folded in:
    mant * exp(e_r[k, h'] + S + e_b[k, h]), complex [K, NO, H, H].

    t_cart: real [2, NO] offsets (one geometry) or [2, K, NO] (each k its
    own); k: real or complex [K]; e_r, e_b: real [K, H].  One K5 launch
    (h of the d = 2 family at k|t|) and one KG launch on CUDA tensors.
    """
    r_t, theta = _polar_offsets(c, None, t_cart)
    if r_t.ndim == 1:
        r_t, theta = r_t[None], theta[None]
    hm, he = spherical_h_scaled(2, 2 * n_end - 1, k[:, None] * r_t)
    m = _a_node_m_on(c, n_end, theta.device)
    return graf_fold(hm, theta, m, m, he, e_r, e_b)


def sr_banded_scaled(c, t_sph, n_end, k, kind="SR", t_cart=None):
    """(mant, S) of the band scan with per-band exponents, for any tree in
    d >= 3 (the 'c'-rooted ones, where rotation + coaxial does not apply).

    S[h', h] = he[n' + n], the exponent of the entry's top Gaunt band; band
    n'' carries its mantissa times exp(min(he[n''] - S, 80)) <= O(1)
    wherever the Gaunt mask keeps it.  t by its spherical mapping or by
    cartesian t_cart [d, ...]; k real or complex, broadcasting against t's
    batch.  One K5 launch (h's mantissas and exponents) and one KS launch
    (ops/band_sr.py) on CUDA tensors.
    """
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    d = c.c_ndim
    z, t_hat, tab, batch = _band_inputs(c, t_sph, t_cart, n_end, n_end, k)
    hm, he = spherical_h_scaled(d, tab.n_bands, z)
    mant = band_sr(band_coefs(hm, d, *_band_consts(d), he=he), t_hat, tab)
    s_mat = he[..., tab.n_o.long()[:, None] + tab.n_i.long()[None, :]]
    return (mant.reshape(batch + mant.shape[-2:]),
            s_mat.reshape(batch + s_mat.shape[-2:]))


def sr_banded_folded(c, t_cart, n_end, k, e_r, e_b):
    """The band-scan (S|R) table with the row and column exponents folded
    in: mant * exp(e_r[k, h'] + S + e_b[k, h]), complex [K, NO, H, H].

    t_cart: real [d, NO] offsets (one geometry) or [d, K, NO] (each k its
    own); k: real or complex [K]; e_r, e_b: real [K, H].  One K5 launch
    (h's mantissas and exponents at k|t|) and one KS launch in fold mode on
    CUDA tensors.
    """
    d = c.c_ndim
    r_t, t_hat = _unit_offsets(c, None, t_cart)
    if r_t.ndim == 1:
        r_t, t_hat = r_t[None], t_hat[None]
    tab = _quad_tables(c, n_end, n_end, r_t.dtype, r_t.device)
    hm, he = spherical_h_scaled(d, tab.n_bands, k[:, None] * r_t)
    coef = band_coefs(hm, d, *_band_consts(d), he=he)
    return band_sr(coef, t_hat, tab, he, e_r, e_b)


def sr_scaled(c, t_sph, n_end, k, kind="SR", t_cart=None, method=None):
    """(mant, S) full (S|R) operator: SR = mant * exp(S), overflow-free in
    any dtype.

    2D: Graf's closed form (`graf_2d_scaled`).  'b'/'bp'-rooted trees in
    d >= 3: mant = D X_mant D^H per offset (the rotation sandwich, by
    degree groups) and S the coaxial log-scale, which is constant on
    degree blocks and so passes D unchanged.  Other roots: the band scan
    with per-band exponents (`sr_banded_scaled`).  Like the JAX package
    this ignores `method` (the scaled path has its own exact algorithm).
    """
    if c.c_ndim == 2:
        return graf_2d_scaled(c, t_sph, n_end, k, kind=kind, t_cart=t_cart)
    if kind != "SR":
        raise ValueError("scaled translation is (S|R)-only (RR is bounded)")
    if c.root.kind not in ("b", "bp"):
        return sr_banded_scaled(c, t_sph, n_end, k, t_cart=t_cart)
    r, pick, rot = _offsets_of(c, n_end, t_sph, t_cart, k)
    mant, s_mat = coaxial_scaled(c, r, n_end, k)
    return _sandwich(pick(mant), rot), pick(s_mat)
