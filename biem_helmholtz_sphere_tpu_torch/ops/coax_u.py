"""KU: the coaxial factor's band tables U at the packed entries.

For each packed entry e = (a, b) of the coaxial factor's child-state
blocks and each band n < NG * G,

    U_n[e] = sum_q (tz w)[q, n] t[a, q] t[b, q]    where l_a + l_b >= n,

and exactly 0 elsewhere (K2 relies on zero bands above an entry's top
group), accumulated in float64 and rounded once to the table's dtype.  It
writes the two forms K2 and its plain version read: `u` [NG * G, nnz] and
the tiles' image `u_tiles` [slabs, 2, _TILE, 4] (`translation/_scaled.py::
_coax_tiles` lays it out: slab s of a tile of top group g at [h, j, b] =
U_{G s + 4 h + b} of the tile's entry j, zero past a ragged tile's end).

`coax_u` launches `csrc/coax_u.cu` on CUDA tensors and runs `_coax_u_plain`
on CPU tensors; the JAX package forms the dense [NB, H, H] einsum on its
device (translation/_scaled.py:135).
"""

from typing import NamedTuple

import torch

from . import kernels

# Bands per scale group (K2's groups of the band sum) and packed entries per
# tile (= csrc/coax_fold.cu and csrc/coax_u.cu kTile)
_GROUP = 8
_TILE = 64
# bytes of the plain version's float64 temporaries per chunk of entries
_U_BYTES = 256 << 20


class _CoaxPlan(NamedTuple):
    """The tiles KU fills, on the tables' device."""

    order: torch.Tensor  # int32 [nnz, 2] (packed index, l_row + 65536 l_col) by top group
    tiles: torch.Tensor  # int32 [n_tiles, 4] (first entry of order, entries, top group, slab)
    slabs: int  # slabs of the image
    ng: int  # band groups of u


def _lsum(order, nnz):
    """l_a + l_b of every packed entry, from `order`."""
    o = order.long()
    ls = torch.empty(nnz, dtype=torch.int64, device=order.device)
    ls[o[:, 0]] = (o[:, 1] & 0xFFFF) + (o[:, 1] >> 16)
    return ls


def _coax_u_plain(tables, layout, plan, dtype):
    """KU's plain version (and its CPU path): (u, u_tiles) in `dtype` from
    the root tables (t [H, q], tz w [q, NB], float64), the child-state
    layout's rows and cols and the plan, by one float64 product per chunk
    of entries and one gather into the tiles."""
    t, tzw = tables
    q, nb = tzw.shape
    nnz = layout.rows.shape[0]
    dev = t.device
    lsum = _lsum(plan.order, nnz)
    u = torch.zeros((plan.ng * _GROUP, nnz), dtype=dtype, device=dev)
    band = torch.arange(nb, device=dev)[:, None]
    chunk = max(1, _U_BYTES // (8 * (q + 2 * nb)))
    for e0 in range(0, nnz, chunk):
        e1 = min(nnz, e0 + chunk)
        prod = t[layout.rows[e0:e1]] * t[layout.cols[e0:e1]]  # [E, q]
        u[:nb, e0:e1] = torch.where(band <= lsum[e0:e1], tzw.T @ prod.T, 0.0).to(dtype)
    tiles = plan.tiles.long()
    size = tiles[:, 2] + 1
    tile = torch.repeat_interleave(torch.arange(len(tiles), device=dev), size)  # of each slab
    local = torch.arange(plan.slabs, device=dev) - tiles[tile, 3]
    j = torch.arange(_TILE, device=dev)
    pos = tiles[tile, :1] + j  # [slabs, _TILE] positions in order
    ent = plan.order[:, 0].long()[pos.clamp(max=nnz - 1)]
    bands = (_GROUP * local[:, None, None] + 4 * torch.arange(2, device=dev)[:, None]
             + torch.arange(4, device=dev))  # [slabs, 2, 4]
    image = u[bands[:, :, None, :], ent[:, None, :, None]]  # [slabs, 2, _TILE, 4]
    image.masked_fill_((j >= tiles[tile, 1:2])[:, None, :, None], 0.0)
    return u, image


def coax_u(tables, layout, plan, dtype):
    """KU wrapper: (u [NG * G, nnz], u_tiles [slabs, 2, _TILE, 4]) in the
    real `dtype`.  Arguments as `_coax_u_plain`.  On CPU tensors this runs
    the plain version; on CUDA tensors it launches csrc/coax_u.cu (one
    launch, counted in `coax_u.launches`) or raises."""
    t, tzw = tables
    if t.device.type == "cpu":
        return _coax_u_plain(tables, layout, plan, dtype)
    if t.device.type != "cuda":
        raise RuntimeError(f"coax_u: unsupported device {t.device}")
    if t.dtype != torch.float64 or tzw.dtype != torch.float64 or dtype not in (
            torch.float32, torch.float64):
        raise TypeError(f"coax_u: tables {t.dtype}, {tzw.dtype}, output {dtype}")
    (_, q), (q2, nb) = t.shape, tzw.shape
    nnz = layout.rows.shape[0]
    if q2 != q or plan.ng * _GROUP < nb or plan.order.shape != (nnz, 2):
        raise ValueError(f"coax_u: t {tuple(t.shape)}, tz w {tuple(tzw.shape)}, "
                         f"{plan.ng} groups, order {tuple(plan.order.shape)}, nnz {nnz}")
    u = torch.zeros((plan.ng * _GROUP, nnz), dtype=dtype, device=t.device)
    image = torch.empty((plan.slabs, 2, _TILE, 4), dtype=dtype, device=t.device)
    kernels.launch("bhs_coax_u", t.contiguous(), tzw.contiguous(), layout.rows, layout.cols,
                   plan.order, plan.tiles, u, image, q, nb, nnz, plan.tiles.shape[0],
                   int(dtype == torch.float64))
    coax_u.launches += 1
    return u, image


coax_u.launches = 0
