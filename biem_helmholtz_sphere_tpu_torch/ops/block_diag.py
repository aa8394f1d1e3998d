"""KB: products of block-diagonal complex matrices with compacted lanes.

The factored (S|R) matvec applies, per offset slot, the rotation D (degree
blocks of size 2l+1, 4.2% nonzero at n_end=32) and its adjoint, and per
(k, radius) the folded coaxial factor X (child-state m-blocks of size
n-|m| after an l<->m permutation, 2.1% nonzero).  The JAX package applies
all three as dense [H, H] einsums over padded lanes
(biem_helmholtz_sphere_tpu/biem/_core.py, the factored `mv`).  Here the
matrices are packed to their diagonal blocks and the lanes are compacted:
x [K, L, H] holds only the lanes that route a pair, sorted so that each
matrix's lanes form one contiguous segment (`LaneSegments`, a CSR over
lanes).  `block_diag_cmm` runs the CUDA kernel `csrc/block_diag_cmm.cu`
on CUDA tensors, from a work list built on the host once per shape
(`work_list`), and the dense per-segment matmuls
(`_block_diag_cmm_plain`) on CPU tensors.
"""

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch

from . import kernels

# work item columns: vals matrix, first k, k count, first lane of the
# segment, segment length, blocks [b0, b1), item lanes [q0, q1) of the
# nk * nl lanes (k-major), rows [r0, r1) of each block (clipped to its size)
ITEM_FIELDS = 11
_ROW_TILE = 4  # rows of a thread's register tile (csrc/block_diag_cmm.cu)
_LANE_TILE = 2  # lanes of a thread's register tile
_THREADS = 256  # threads of a CTA: a row-panel item has at most one tile each
_PANEL_LANES = 64  # most lanes of a row-panel item
_ITEMS_PER_LAUNCH = 264  # work target: two items per SM of a 132-SM H100
_BUF_BYTES = 56 * 1024  # one staging buffer: two per CTA, two CTAs per SM
_SMEM_MAX = 232448  # dynamic shared memory a block may use on Hopper


@dataclass(frozen=True)
class BlockDiag:
    """A stack of block-diagonal [H, H] matrices, packed.

    Block b covers packed-layout rows/cols offs[b] .. offs[b]+sizes[b]; the
    packed layout maps to the basis layout through `perm` (None: identity).
    vals[..., voffs[b] + i*size + j] holds entry (i, j) of block b.
    """

    vals: torch.Tensor | None  # complex [..., nnz] (None: a layout only)
    offs: torch.Tensor  # int32 [nblk]
    sizes: torch.Tensor  # int32 [nblk]
    voffs: torch.Tensor  # int32 [nblk]
    rows: torch.Tensor  # int64 [nnz] basis row of each packed value
    cols: torch.Tensor  # int64 [nnz] basis column of each packed value
    perm: torch.Tensor | None  # int32 [H] packed index -> basis index
    h: int
    block_sizes: tuple  # sizes, on the host


@dataclass(frozen=True)
class LaneSegments:
    """Lanes ptr[m] .. ptr[m+1] of x [K, L, H] are multiplied by matrix m.

    A matrix stack [M, nnz] is shared by the K k's; a stack [K, M, nnz]
    has one matrix m per k.
    """

    ptr: tuple  # M + 1 nondecreasing lane offsets, ptr[0] = 0, ptr[-1] = L


def pack_layout(sizes, perm, h, device):
    """The packed layout of block-diagonal [h, h] matrices, without values
    (vals=None): block sizes in the packed layout, perm maps packed ->
    basis (None: identity)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.sum() != h:
        raise ValueError(f"block sizes sum to {sizes.sum()}, not H={h}")
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    voffs = np.concatenate([[0], np.cumsum(sizes * sizes)[:-1]])
    p = np.arange(h) if perm is None else np.asarray(perm, dtype=np.int64)
    rows = np.concatenate([np.repeat(p[o : o + g], g) for o, g in zip(offs, sizes)])
    cols = np.concatenate([np.tile(p[o : o + g], g) for o, g in zip(offs, sizes)])

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=device)

    return BlockDiag(
        vals=None,
        offs=t(offs), sizes=t(sizes), voffs=t(voffs),
        rows=t(rows, torch.int64), cols=t(cols, torch.int64),
        perm=None if perm is None else t(p),
        h=h, block_sizes=tuple(int(g) for g in sizes),
    )


def pack(dense, sizes, perm=None):
    """Pack dense [..., H, H] matrices that vanish off the given diagonal
    blocks (block sizes in the packed layout; perm maps packed -> basis)."""
    lay = pack_layout(sizes, perm, int(dense.shape[-1]), dense.device)
    return replace(lay, vals=dense[..., lay.rows, lay.cols].contiguous())


def unpack(a):
    """The dense [..., H, H] matrices of a BlockDiag (zeros off the blocks)."""
    dense = a.vals.new_zeros(a.vals.shape[:-1] + (a.h, a.h))
    dense[..., a.rows, a.cols] = a.vals
    return dense


def _round_up(v, m):
    return -(-v // m) * m


def _panel_items(g, q_all):
    """(rows per panel, lanes per chunk) of a block of size g too large to
    stage whole with q_all lanes: lane chunks of at most _PANEL_LANES, and
    row panels as tall as one 4-row x 2-lane tile per thread allows, both
    evened out over the block."""
    n_lc = -(-q_all // _PANEL_LANES)
    lanes = _round_up(-(-q_all // n_lc), _LANE_TILE)
    rows = _ROW_TILE * (_THREADS // (lanes // _LANE_TILE))
    n_rp = -(-g // rows)
    return _round_up(-(-g // n_rp), _ROW_TILE), lanes


def work_list(block_sizes, seg_ptr, n_k, per_k, budget):
    """The kernel's work items, largest first: int32 [n, ITEM_FIELDS].

    One item applies a run of consecutive diagonal blocks of one matrix to
    a run of its lanes (all K k's for a shared matrix).  Items aim at the
    total work over _ITEMS_PER_LAUNCH, work counted as g^2 x lanes; a
    block whose work alone exceeds that target has its lanes split into
    even chunks (its values are then read once per chunk).  `budget` bounds an item's
    staging footprint in complex elements: each block takes g x gp for
    op(A) (gp: g rounded up to the row tile) and lanes x g for the lanes'
    slices (lanes rounded up to the lane tile).  A block that does not fit
    the budget with two lanes is cut into row panels [r0, r1) x lane
    chunks (`_panel_items`), each staged column panel by column panel
    (`item_stages`).  Matrices with no lanes get no item.  Every
    (matrix, block, row, k, lane) is covered exactly once.
    """
    # the smallest panel (4 rows x 2 lanes x 1 column) always fits
    assert budget >= _ROW_TILE + _LANE_TILE, budget
    g = np.asarray(block_sizes, dtype=np.int64)
    gp = _round_up(g, _ROW_TILE)
    seg = np.asarray(seg_ptr, dtype=np.int64)
    n_mat = len(seg) - 1
    units = []  # (vals matrix, k0, nk, lane0, nl)
    for m in range(n_mat):
        nl = int(seg[m + 1] - seg[m])
        if nl == 0:
            continue
        if per_k:
            units += [(k * n_mat + m, k, 1, int(seg[m]), nl) for k in range(n_k)]
        else:
            units.append((m, 0, n_k, int(seg[m]), nl))
    g2 = g * g
    target = max(1, sum(u[2] * u[4] for u in units) * int(g2.sum()) // _ITEMS_PER_LAUNCH)
    fit = (budget - g * gp) // g // _LANE_TILE * _LANE_TILE  # most lanes per block
    whole = fit >= _LANE_TILE
    fit = np.maximum(fit, _LANE_TILE)
    items, work = [], []
    for mat, k0, nk, lane0, nl in units:
        q_all = nk * nl
        # lanes per chunk for each block: the whole segment unless the
        # block's work exceeds the target or its footprint the budget
        chunks = np.maximum(-(-g2 * q_all // target), -(-q_all // fit))
        chunk = np.minimum(_round_up(-(-q_all // chunks), _LANE_TILE), fit)
        run = None  # open item over whole lanes: [b0, b1, work, footprint]
        for b in range(len(g)):
            gb = int(g[b])
            if not whole[b]:  # row panels x lane chunks
                rows, lanes = _panel_items(gb, q_all)
                for q0 in range(0, q_all, lanes):
                    q1 = min(q_all, q0 + lanes)
                    for r0 in range(0, gb, rows):
                        r1 = min(gb, r0 + rows)
                        items.append((mat, k0, nk, lane0, nl, b, b + 1, q0, q1, r0, r1))
                        work.append(gb * (r1 - r0) * (q1 - q0))
                continue
            if chunk[b] < q_all:
                for q0 in range(0, q_all, int(chunk[b])):
                    q1 = min(q_all, q0 + int(chunk[b]))
                    items.append((mat, k0, nk, lane0, nl, b, b + 1, q0, q1, 0, gb))
                    work.append(int(g2[b]) * (q1 - q0))
                continue
            w_b = int(g2[b]) * q_all
            f_b = int(g[b] * gp[b] + _round_up(q_all, _LANE_TILE) * g[b])
            if run is not None and (run[1] != b or run[2] + w_b > target
                                    or run[3] + f_b > budget):
                items.append((mat, k0, nk, lane0, nl, run[0], run[1], 0, q_all, 0,
                              int(g[run[0]:run[1]].max())))
                work.append(run[2])
                run = None
            if run is None:
                run = [b, b, 0, 0]
            run[1], run[2], run[3] = b + 1, run[2] + w_b, run[3] + f_b
        if run is not None:
            items.append((mat, k0, nk, lane0, nl, run[0], run[1], 0, q_all, 0,
                          int(g[run[0]:run[1]].max())))
            work.append(run[2])
    order = np.argsort(-np.asarray(work, dtype=np.int64), kind="stable")
    return np.asarray(items, dtype=np.int32).reshape(-1, ITEM_FIELDS)[order]


def item_stages(items, block_sizes, buf):
    """(staging footprint in complex elements, column panels) of each work
    item with staging buffers of buf elements, as the kernel stages it:
    block b's rows [r0, min(r1, g)) padded to the row tile (rp), its lanes
    padded to the lane tile (Qp), and columns in panels of min(g, buf //
    (rp + Qp)); an item over several blocks, or a block that fits, is one
    panel.  The sum over a row runs over the columns in order across the
    panels."""
    g = np.asarray(block_sizes, dtype=np.int64)
    foot = np.zeros(len(items), dtype=np.int64)
    panels = np.ones(len(items), dtype=np.int64)
    for i, (b0, b1, q0, q1, r0, r1) in enumerate(items[:, 5:11].astype(np.int64)):
        qp = _round_up(q1 - q0, _LANE_TILE)
        for gb in g[b0:b1]:
            rp = _round_up(min(r1, gb) - r0, _ROW_TILE)
            cols = min(gb, buf // (rp + qp))
            foot[i] += cols * (rp + qp)
            panels[i] = max(panels[i], -(-gb // cols))
    return foot, panels


def _on_card(items, device):
    """The work list on `device` without a host sync: the plan is built at
    a matvec inside GMRES's step loop, whose host must not wait on the card
    (a pageable copy would), so on the card it goes through pinned memory."""
    items = torch.as_tensor(items)
    if device.type != "cuda":
        return items.to(device)
    return items.pin_memory().to(device, non_blocking=True)


@lru_cache(maxsize=32)
def _plan(block_sizes, seg_ptr, n_k, per_k, elem_bytes, device):
    """(items on the device, item count, elements per staging buffer, and
    whether any item takes row or column panels)."""
    budget = _BUF_BYTES // elem_bytes
    need = max(g * _round_up(g, _ROW_TILE) + _LANE_TILE * g for g in block_sizes)
    if budget < need <= _SMEM_MAX // 2 // elem_bytes:
        # one block and two lanes fit a larger buffer (one CTA per SM)
        budget = _SMEM_MAX // 2 // elem_bytes
    items = work_list(block_sizes, seg_ptr, n_k, per_k, budget)
    if not len(items):
        return _on_card(items, device), 0, 0, False
    foot, panels = item_stages(items, block_sizes, budget)
    # a multiple of 4 elements keeps the second buffer 16-byte aligned;
    # the kernel's column panels at this buffer equal those at the budget
    buf = _round_up(int(foot.max()), 4)
    g = np.asarray(block_sizes)
    paneled = bool((panels > 1).any() or (items[:, 9] > 0).any()
                   or (items[:, 10] < g[items[:, 5]]).any())
    return _on_card(items, device), len(items), buf, paneled


def _block_diag_cmm_plain(dense, x, seg, adjoint):
    """y[k, l] = op(A_m) x[k, l] for the lanes l of segment m; dense
    [M, H, H] shared by the k's, or [K, M, H, H]."""
    y = torch.zeros_like(x)
    for m, (lo, hi) in enumerate(zip(seg.ptr[:-1], seg.ptr[1:])):
        if lo == hi:
            continue
        a = dense[..., m, :, :]
        # adjoint: y_h = sum_g conj(A[g, h]) x_g; else y_h = sum_g A[h, g] x_g
        y[:, lo:hi] = x[:, lo:hi] @ (a.conj() if adjoint else a.transpose(-1, -2))
    return y


def block_diag_cmm(a, x, seg, adjoint=False):
    """op(A_m) applied to the lanes of each segment m: x, y complex [K, L, H].

    a.vals is [M, nnz] (shared by the k's, e.g. D) or [K, M, nnz] (one
    matrix per k, e.g. X); seg is a LaneSegments with M + 1 offsets ending
    at L.  op is the identity or, with adjoint=True, the conjugate
    transpose.
    """
    n_k, n_lanes, h = x.shape
    stack = tuple(a.vals.shape[:-1])
    n_mat = len(seg.ptr) - 1
    per_k = len(stack) == 2
    if stack not in ((n_mat,), (n_k, n_mat)) or seg.ptr[-1] != n_lanes or h != a.h:
        raise ValueError(
            f"x {tuple(x.shape)} does not match the matrix stack {stack} of "
            f"[{a.h}, {a.h}] matrices over {n_mat} lane segments ending at {seg.ptr[-1]}"
        )
    if x.device.type == "cpu":
        return _block_diag_cmm_plain(unpack(a), x, seg, adjoint)
    if x.device.type != "cuda":
        raise RuntimeError(f"block_diag_cmm: unsupported device {x.device}")
    if x.dtype not in (torch.complex64, torch.complex128) or a.vals.dtype != x.dtype:
        raise TypeError(f"block_diag_cmm: dtypes {a.vals.dtype}, {x.dtype}")
    items, n_items, buf, paneled = _plan(a.block_sizes, tuple(seg.ptr), n_k, per_k,
                                         x.element_size(), x.device)
    x = x.contiguous()
    y = torch.empty_like(x)
    kernels.launch(
        "bhs_block_diag_cmm", a.vals, a.offs, a.sizes, a.voffs,
        0 if a.perm is None else a.perm, items, n_items, x, y,
        a.vals.shape[-1], n_lanes, h, buf, int(adjoint),
        int(x.dtype == torch.complex128),
    )
    block_diag_cmm.launches += 1
    block_diag_cmm.panel_launches += int(paneled)
    return y


block_diag_cmm.launches = 0
block_diag_cmm.panel_launches = 0  # of them, launches whose work list has panels
