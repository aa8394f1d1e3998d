r"""KR: the plane-wave right-hand side.

From the plane-wave expansion e^{i k x.d^} = A_d sum_h i^{n_h}
j_{n_h}(k|x|) Y_h(x^) conj(Y_h(d^)), the boundary data of a plane wave on
sphere b, projected on conj(Y_h), is

    f_h(k, b) = -A_d i^{n_h} e^{i k d^.c_b} conj(Y_h(d^))
                (alpha_b j_{n_h}(k rho_b) + beta_b k j'_{n_h}(k rho_b))

(the JAX package's `biem/_core.py::_rhs_plane_wave`, which XLA fused on
the TPU), the alpha term where u_in was given, the beta term where its
gradient was.  `plane_wave_rhs` takes j and j' as K5 writes them
(`special/_family.py::spherical_jh_all` at k rho_b) and launches
`csrc/plane_rhs.cu` on CUDA tensors; on CPU tensors it runs
`plane_wave_rhs_plain`, the same formula in plain torch through
`harmonics/_eval.py::harmonics`.

The kernel keeps conj(Y_h(d^)) i^{n_h} (-A_d) across calls in a device
table (`_KrTable`, one per (tree, n_end, dtype, device, stream)): a slice
per (unit of _UNIT walk entries, range of rows) with the bits of the
direction it was formed at, which the kernel compares with its first k's
on the card (no host read).  Launches on one stream run in order, so a
table per stream is never touched by two launches at once.  It forms cy
in double from the tree's float64 program in both dtypes.  The grid
(`_grid`) spreads the (k, b) rows over the card.  The arguments of a
launch (`_kr_inputs`, with its checks) are kept per shapes, strides,
dtypes, device and stream (`_packs`), so a warm call only reads the
tensors' layouts, allocates `out` and launches.
"""

from functools import lru_cache

import numpy as np
import torch

from ..harmonics._index import basis
from ..translation._ops import _a_const, ipow
from . import kernels
from .harmonic_program import harmonic_program

# a CTA's threads and the walk entries each owns (plane_rhs.cu kThreads,
# kPer): a unit of _UNIT consecutive walk entries a CTA
_THREADS = 128
_PER = 2
_UNIT = _THREADS * _PER
# CTAs a launch aims at (two per SM of a 132-SM H100): the (k, b) rows are
# split into ranges until the units x ranges reach it (one row a range at
# most)
_FILL_CTAS = 2 * 132
# bytes a kept table's copies of cy may take: one copy per range of rows,
# at most _FILL_CTAS copies
_CY_BYTES = 16 << 20
# the launch arguments kept (`_packs`); past this many layouts it starts over
_MAX_PACKS = 64


@lru_cache(maxsize=32)
def rhs_tables(c, n_end, device):
    """(n_idx [H] int64, cy_scale [H] complex128: i^{n_h} (-A_d)) of the
    plain version on `device`; cached."""
    n_root = basis(c, n_end).n_root
    n_idx = torch.as_tensor(n_root, dtype=torch.long, device=device)
    return n_idx, ipow(n_idx, torch.complex128, device) * (-_a_const(c.c_ndim))


def plane_wave_rhs_plain(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                         has_grad):
    """KR's plain version (and its CPU path): [K, B, H].

    j, jp [K, B, n_end] (complex), kw [K] real or complex, direction [d, K]
    (unit), centers [B, d] or [K, B, d], alpha / beta broadcastable to
    [K, B].  conj(Y_h(d^)) i^{n_h} (-A_d) is formed in float64 and rounded
    once, and d^.c_b summed over the axes in order, each product and sum
    rounded alone, as the kernel forms them."""
    from ..coords import from_cartesian
    from ..harmonics._eval import harmonics

    n_idx, cy_scale = rhs_tables(c, n_end, j.device)
    term = 0.0
    if has_uin:
        term = term + alpha[..., None] * j.index_select(-1, n_idx)
    if has_grad:
        term = term + beta[..., None] * (jp.index_select(-1, n_idx) * kw[:, None, None])
    # conj(Y) i^n (-A_d) in float64, rounded once (as the kernel forms it)
    y_dir = harmonics(c, from_cartesian(c, direction.double()), n_end)  # [K, H]
    cy = (y_dir.conj() * cy_scale).to(j.dtype)
    centers = centers.expand(kw.shape[0], -1, -1) if centers.ndim == 2 else centers
    ip = direction[0][:, None] * centers[..., 0]
    for i in range(1, c.c_ndim):
        ip = ip + direction[i][:, None] * centers[..., i]
    phase = torch.exp(1j * kw[:, None] * ip)  # e^{i k d^.c_b}, complex k too
    return (phase[..., None] * term) * cy[:, None, :]


def _units(h_num):
    """Units of _UNIT walk entries (the grid's x)."""
    return -(-h_num // _UNIT)


def _r_cap(h_num, elem):
    """Copies of cy a table keeps (the most ranges of rows a launch may
    have): _FILL_CTAS, fewer where H copies of `elem` bytes would pass
    _CY_BYTES."""
    return max(1, min(_FILL_CTAS, _CY_BYTES // (h_num * elem)))


def _grid(h_num, rows, r_cap):
    """(units, rows a CTA, ranges of rows) of a launch over `rows` (k, b)
    rows: as many ranges as bring units x ranges to _FILL_CTAS, at most one
    a row and at most r_cap."""
    units = _units(h_num)
    want = max(1, min(r_cap, rows, -(-_FILL_CTAS // units)))
    rows_per = -(-rows // want)
    return units, rows_per, -(-rows // rows_per)


class _KrTable:
    """The kept cy of one (tree, n_end, complex dtype, device, stream): cy
    [r_cap, H] in the walk's order and its stamps [r_cap, units, d + 1]
    (zero: no slice formed)."""

    def __init__(self, c, n_end, dtype, device):
        h_num = basis(c, n_end).num
        rdt = kernels.REAL_OF[dtype]
        self.r_cap = _r_cap(h_num, torch.empty((), dtype=dtype).element_size())
        self.cy = torch.zeros((self.r_cap, h_num), dtype=dtype, device=device)
        self.stamp = torch.zeros((self.r_cap, _units(h_num), c.c_ndim + 1), dtype=rdt,
                                 device=device)


@lru_cache(maxsize=32)
def kr_table(c, n_end, dtype, device, stream):
    """The kept table (`_KrTable`) of (tree, n_end, complex dtype, device,
    stream handle: None on the CPU); cached.  Made while `stream` is
    current, so its zeroed stamps are ordered before that stream's
    launches."""
    return _KrTable(c, n_end, dtype, torch.device(device))


def _kr_inputs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad,
               stream=None):
    """(out shape, arguments) of a KR launch, checked: the arguments as
    csrc/plane_rhs.cu's entry takes them after `out`, by its order, with
    the program `pg` in place of its tables, the kept table `tab` in place
    of cy and its stamps (that of `stream`, the current stream's handle),
    and the tensors in place of their addresses (strides in elements; a
    shared geometry, direction, k, alpha or beta has stride 0 along K)."""
    cdt = j.dtype
    if cdt not in kernels.REAL_OF:
        raise TypeError(f"plane_wave_rhs: dtype {cdt}")
    rdt = kernels.REAL_OF[cdt]
    d = c.c_ndim
    n_k, n_balls, ne = j.shape
    h_num = basis(c, n_end).num
    if (ne != n_end or jp.shape != j.shape or jp.dtype != cdt or not j.is_contiguous()
            or not jp.is_contiguous()):
        raise ValueError(f"plane_wave_rhs: j {tuple(j.shape)}, j' {tuple(jp.shape)} "
                         f"(contiguous [K, B, {n_end}] each)")
    if (direction.shape != (d, n_k) or centers.shape[-2:] != (n_balls, d)
            or centers.ndim not in (2, 3) or (centers.ndim == 3 and centers.shape[0] != n_k)
            or kw.shape != (n_k,)):
        raise ValueError(f"plane_wave_rhs: k {tuple(kw.shape)}, direction "
                         f"{tuple(direction.shape)}, centers {tuple(centers.shape)} for "
                         f"K={n_k}, B={n_balls}, d={d}")
    if direction.dtype != rdt or centers.dtype != rdt or kw.dtype not in (rdt, cdt):
        raise TypeError(f"plane_wave_rhs: k {kw.dtype}, direction {direction.dtype}, centers "
                        f"{centers.dtype} with {cdt}")
    alpha, beta = (t.expand(n_k, n_balls) for t in (alpha, beta))
    if alpha.dtype != cdt or beta.dtype != cdt:
        raise TypeError(f"plane_wave_rhs: alpha {alpha.dtype}, beta {beta.dtype} with {cdt}")
    cen = centers if centers.ndim == 3 else centers[None].expand(n_k, -1, -1)
    pg = harmonic_program(c, n_end, torch.float64, j.device)
    tab = kr_table(c, n_end, cdt, j.device, stream)
    _, rows_per, _ = _grid(h_num, n_k * n_balls, tab.r_cap)
    return (n_k, n_balls, h_num), (
        j, jp, kw, kw.stride(0), int(kw.is_complex()), direction, direction.stride(0),
        direction.stride(1), cen, cen.stride(0), cen.stride(1), cen.stride(2), alpha,
        alpha.stride(0), alpha.stride(1), beta, beta.stride(0), beta.stride(1), pg, tab, h_num,
        d, int(has_uin), int(has_grad), rows_per, -_a_const(d))


def _layout(t):
    return t.shape, t.stride(), t.dtype


# The slots of a launch pack, as csrc/plane_rhs.cu's enum Slot orders them
_SLOTS = ("skv", "kc", "sdd", "sdk", "sck", "scb", "scd", "sak", "sab", "sbk", "sbb", "hn",
          "wcs", "hjob", "nodes", "jobs", "fam", "coef", "famr", "n_nodes", "shape",
          "walk", "wfam", "wroot", "wstep", "cy", "stamp", "K", "B", "H", "ne", "d", "has_uin",
          "has_grad", "rows_per", "r_cap", "neg_a", "dbl")

# launch packs: (tree, n_end, has_uin, has_grad, device, stream handle, the
# layouts of j, jp, k, direction, centers, alpha, beta) -> (out shape, the
# slots as int64 [len(_SLOTS)], the kept table, the program)
_packs = {}


def _pack(key, c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad,
          stream):
    """The launch pack of `key` (see _packs): `_kr_inputs`' checks, and its
    fixed arguments in the kernel's slots (the program's and the table's
    tensors by address: they live as long as their caches keep them, and
    the pack holds them too), so that a warm call passes the tensors and
    one address."""
    shape, args = _kr_inputs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                             has_grad, stream)
    (_, _, _, skv, kc, _, sdd, sdk, _, sck, scb, scd, _, sak, sab, _, sbk, sbb, pg, tab, h_num,
     d, has_uin, has_grad, rows_per, neg_a) = args
    vals = dict(
        skv=skv, kc=kc, sdd=sdd, sdk=sdk, sck=sck, scb=scb, scd=scd, sak=sak, sab=sab, sbk=sbk,
        sbb=sbb, n_nodes=pg.n_nodes, shape=pg.shape, K=shape[0], B=shape[1], H=h_num,
        ne=j.shape[2], d=d, has_uin=has_uin, has_grad=has_grad, rows_per=rows_per,
        r_cap=tab.r_cap, neg_a=int(np.float64(neg_a).view(np.int64)),
        dbl=int(j.dtype == torch.complex128),
        hn=pg.ke_hn.data_ptr(),
        **{name: getattr(pg, name).data_ptr() for name in (
            "wcs", "hjob", "nodes", "jobs", "fam", "coef", "famr", "walk", "wfam", "wroot",
            "wstep")},
        cy=tab.cy.data_ptr(), stamp=tab.stamp.data_ptr())
    slots = np.array([vals[name] for name in _SLOTS], dtype=np.int64)
    if len(_packs) >= _MAX_PACKS:
        _packs.clear()
    _packs[key] = pack = (shape, slots, tab, pg)
    return pack


def _launch_pack(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad,
                 stream=None):
    """The launch pack of these arguments' layouts on `stream` (`_packs`),
    made at their first call."""
    key = (c, n_end, bool(has_uin), bool(has_grad), j.device, stream,
           *map(_layout, (j, jp, kw, direction, centers, alpha, beta)))
    pack = _packs.get(key)
    if pack is None:
        pack = _pack(key, c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                     has_grad, stream)
    return pack


def plane_wave_rhs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad):
    """KR wrapper: the plane-wave right-hand side [K, B, H].  Arguments as
    `plane_wave_rhs_plain`.  On CPU tensors this runs the plain version; on
    CUDA tensors it launches csrc/plane_rhs.cu on the current stream (one
    launch, counted in `plane_wave_rhs.launches`, with the stream's kept
    table) or raises.  Once the tree's program and table are cached on the
    card it copies nothing from the host and waits on nothing."""
    if j.device.type == "cpu":
        return plane_wave_rhs_plain(c, n_end, j, jp, kw, direction, centers, alpha, beta,
                                    has_uin, has_grad)
    if j.device.type != "cuda":
        raise RuntimeError(f"plane_wave_rhs: unsupported device {j.device}")
    shape, slots, _, _ = _launch_pack(c, n_end, j, jp, kw, direction, centers, alpha, beta,
                                      has_uin, has_grad,
                                      kernels.current_stream_handle(j.device.index))
    out = torch.empty(shape, dtype=j.dtype, device=j.device)
    kernels.launch("bhs_plane_rhs", slots.ctypes.data, out, j, jp, kw, direction, centers, alpha,
                   beta)
    plane_wave_rhs.launches += 1
    return out


plane_wave_rhs.launches = 0
