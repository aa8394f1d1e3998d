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
device (translation/_scaled.py:135).  The kernel forms each tile's product
D[_TILE, G (g + 1)] = P T on the FP64 tensor cores into the image, then
writes u from it: `_ku_work` mirrors which warp takes which (m16 tile of
entries, band group) in which pass, and `_ku_smem` its shared memory,
which the kernel checks against its own.
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
# the kernel's plan (csrc/coax_u.cu): threads a CTA (8 warps: 4 m16 tiles of
# the tile's entries x 2 parities of band groups), nodes a stage of its
# cp.async ring and the ring's stages, band groups a warp holds in float64
# registers in one pass (so a pass covers 2 _KU_GROUPS_W groups: every
# group of n_end <= 64), the t rows' and tz w's row strides in shared
# memory (padded against bank conflicts)
_KU_THREADS = 256
_KU_CHUNK = 8
_KU_STAGES = 5
_KU_GROUPS_W = 8
_KU_GROUPS_PASS = 2 * _KU_GROUPS_W
_KU_TSTRIDE = _KU_CHUNK + 4
_KU_ZSTRIDE = _KU_GROUPS_PASS * _GROUP + 4
# Up to one CTA an SM of tiles, the kernel's first pass writes its tiles'
# columns of u itself (its instance for that, with the registers of a CTA
# alone on an SM); past that a second pass writes u's rows whole from the
# image (the first pass then runs two CTAs an SM: 105 KB of shared memory
# and 128 registers a thread each)


class _CoaxPlan(NamedTuple):
    """The tiles KU fills, on the tables' device."""

    order: torch.Tensor  # int32 [nnz, 2] (packed index, l_row + 65536 l_col) by top group
    tiles: torch.Tensor  # int32 [n_tiles, 4] (first entry of order, entries, top group, slab)
    slabs: int  # slabs of the image
    ng: int  # band groups of u


def _ku_smem():
    """The kernel's dynamic shared memory in bytes: the ring's stages (rows
    t_a and t_b and tz w's chunk each), then the tile's row and column
    offsets (int64), packed indices and l + l' (int32); the same whatever q
    and n_end."""
    stage = 2 * _TILE * _KU_TSTRIDE + _KU_CHUNK * _KU_ZSTRIDE
    return 8 * _KU_STAGES * stage + _TILE * (2 * 8 + 2 * 4)


def _ku_work(top_group):
    """The kernel's work on a tile of top group `top_group`, as it splits
    it: [(pass, warp, first entry of its m16 tile, band group)], each warp
    w taking m tile w % 4 and, of each pass's _KU_GROUPS_PASS groups, those
    of parity w // 4 (at most _KU_GROUPS_W)."""
    out = []
    n_groups = top_group + 1
    for p, pb in enumerate(range(0, n_groups, _KU_GROUPS_PASS)):
        gp = min(_KU_GROUPS_PASS, n_groups - pb)
        for w in range(_KU_THREADS // 32):
            for gi in range(_KU_GROUPS_W):
                lg = 2 * gi + w // 4
                if lg < gp:
                    out.append((p, w, 16 * (w % 4), pb + lg))
    return out


def _ku_direct(n_tiles, n_sm):
    """Whether the kernel's first pass writes u itself: its tiles are one
    wave of a CTA an SM on a card of n_sm SMs."""
    return n_tiles <= n_sm


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
    the plain version; on CUDA tensors it launches csrc/coax_u.cu (the
    tiles' product into the image, then u from it: by each tile's CTA where
    the tiles are one wave, else by a second pass; counted once in
    `coax_u.launches`) or raises."""
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
    u = torch.empty((plan.ng * _GROUP, nnz), dtype=dtype, device=t.device)
    image = torch.empty((plan.slabs, 2, _TILE, 4), dtype=dtype, device=t.device)
    where = torch.empty(nnz, dtype=torch.int32, device=t.device)
    direct = _ku_direct(plan.tiles.shape[0],
                        torch.cuda.get_device_properties(t.device).multi_processor_count)
    kernels.launch("bhs_coax_u", t.contiguous(), tzw.contiguous(), layout.rows, layout.cols,
                   plan.order, plan.tiles, u, image, where, q, nb, nnz, plan.tiles.shape[0],
                   plan.ng, int(direct), _ku_smem(), int(dtype == torch.float64))
    coax_u.launches += 1
    return u, image


coax_u.launches = 0
