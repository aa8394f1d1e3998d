"""KD: the dense BIEM matrix, gathered from the unique-offset (S|R) table.

The dense routes (direct LU and dense GMRES) solve with the assembled
matrix

    A[k, b, b', h, h'] = rowf[k, b, h] s T[k, pid[k, b, b'], h, h'] s' colf[k, b', h']

off the diagonal blocks, with s = (-1)^{n_h} on the mirror blocks (b > b',
whose offset is the negative of its pair's: SR(-t)[h, h'] =
(-1)^{n_h + n_h'} SR(t)[h, h']) and 1 elsewhere, and delta_{hh'} diag[k,
b, h] on the diagonal blocks.  The JAX package builds it in one fused XLA
pass (biem_helmholtz_sphere_tpu/biem/_core.py::_assemble, block-gather
branch, and `_diag_scatter` for one sphere).  `dense_assemble` runs the
CUDA kernel `csrc/dense_assemble.cu` on CUDA tensors and
`_dense_assemble_plain` on CPU tensors, in either layout: pair-major
[K, B, B', H, H'] (dense GMRES) or [K, B, H, B', H'] (the [N, N] matrix of
LU and `calc.matrix`), written directly, with no transposing copy; in the
latter layout it can write a window of rows alone (a row-sharded solve,
parallel.sharded_solve).  The
pair map pid is [B, B] for a geometry shared by the batch, or [K, B, B]
for geometry that varies along it (each k's table holds that k's own
offsets).
"""

import torch

from . import kernels


def _dense_assemble_plain(table, pid, rowf, colf, sgn, diag, pair_major, rows=None):
    """Plain version of the KD kernel (and its CPU path); arguments as
    `dense_assemble`.  One ball's block row [B', H, H] at a time: the same
    products, in the same shapes, whether the whole matrix or a row window
    is asked for, so a window's entries equal the whole matrix's."""
    n_k, n_b, h = rowf.shape
    dev = rowf.device
    r0, r1 = (0, n_b * h) if rows is None else rows
    lower = torch.ones(n_b, n_b, dtype=torch.bool, device=dev).tril(-1)
    s = torch.where(lower[..., None], sgn, torch.ones_like(sgn))  # [B, B', H]
    rowm = rowf[:, :, None, :] * s  # [K, B, B', H]
    colm = colf[:, None, :, :] * s
    pid = pid.long().expand(n_k, n_b, n_b)
    shape = (n_k, n_b, n_b, h, h) if pair_major else (n_k, r1 - r0, n_b, h)
    out = torch.empty(shape, dtype=rowf.dtype, device=dev)
    for k in range(n_k):
        for b in range(r0 // h, -(-r1 // h)):  # the balls whose rows meet the window
            if table.shape[1]:
                blk = (rowm[k, b][..., None] * table[k, pid[k, b]]) * colm[k, b][:, None, :]
            else:  # one sphere: no offsets
                blk = rowf.new_zeros((n_b, h, h))
            blk[b] = torch.diag_embed(diag[k, b])
            if pair_major:
                out[k, b] = blk
            else:
                lo, hi = max(r0, b * h), min(r1, (b + 1) * h)
                out[k, lo - r0 : hi - r0] = blk.transpose(0, 1)[lo - b * h : hi - b * h]
    if pair_major or rows is not None:
        return out
    return out.view(n_k, n_b, h, n_b, h)


def _pair_order(pid):
    """int32 [..., B * B, 3] (b, b', offset id) for the kernel's CTAs, per
    pair map pid [..., B, B]: the off-diagonal pairs sorted by offset id
    (stable), then the diagonal pairs (id 0, unused)."""
    n_b = pid.shape[-1]
    dev = pid.device
    bb = torch.arange(n_b, device=dev)
    b, bp = torch.meshgrid(bb, bb, indexing="ij")
    diag = b == bp
    ids = torch.where(diag, 0, pid.long())
    key = torch.where(diag, n_b * n_b + b, ids)  # diagonal pairs last
    order = torch.sort(key.flatten(-2), stable=True).indices
    rows = torch.stack(torch.broadcast_tensors(b, bp, ids), dim=-1).flatten(-3, -2)
    return torch.take_along_dim(rows, order[..., None], dim=-2).to(torch.int32).contiguous()


def _window_pairs(pairs, h, r0, r1):
    """The pairs of `_pair_order` whose ball b has rows in the window
    [r0, r1) of the flat row index b * H + h, in their order."""
    b = pairs[..., 0]
    keep = (b >= r0 // h) & (b <= (r1 - 1) // h)
    return pairs[keep].reshape(pairs.shape[:-2] + (-1, 3)).contiguous()


def _window_tiles(h, r0, r1, rows_per_tile):
    """Tiles of rows_per_tile rows h per ball that KD's grid needs: the most
    that any ball meeting the window [r0, r1) has inside it."""
    most = 0
    for b in range(r0 // h, (r1 - 1) // h + 1):
        lo, hi = max(r0 - b * h, 0), min(r1 - b * h, h)
        most = max(most, -(-hi // rows_per_tile) - lo // rows_per_tile)
    return most


_KD_ROWS = 16  # csrc/dense_assemble.cu: kRows, the rows h of a CTA's tile


def dense_assemble(table, pid, rowf, colf, sgn, diag, pair_major=False, rows=None):
    """The dense BIEM matrix from its unique-offset table.

    table: complex [K, NO, H, H] (the (S|R) of each distinct offset, folded
    or plain); pid: int [B, B] offset id of each pair (the diagonal
    ignored), or [K, B, B] each k's own; rowf, colf, diag: complex [K, B, H] (row factor, column
    factor, diagonal); sgn: real [H], (-1)^{n_h}.  Returns complex
    [K, B, B', H, H'] if pair_major, else [K, B, H, B', H'].  rows = (r0,
    r1) (not with pair_major) asks for the rows r0 <= b * H + h < r1 of
    the [B H, B' H'] matrix alone: [K, r1 - r0, B', H'], equal entry for
    entry to those rows of the whole (a window may cut a ball's rows).  On
    CPU tensors this runs the plain version; on CUDA tensors it launches
    csrc/dense_assemble.cu or raises.
    """
    n_k, n_b, h = rowf.shape
    if (table.shape[0] != n_k or table.shape[2:] != (h, h)
            or pid.shape not in ((n_b, n_b), (n_k, n_b, n_b))
            or colf.shape != rowf.shape or diag.shape != rowf.shape or sgn.shape != (h,)):
        raise ValueError(
            f"dense_assemble: table {tuple(table.shape)}, pid {tuple(pid.shape)}, rowf "
            f"{tuple(rowf.shape)}, colf {tuple(colf.shape)}, diag {tuple(diag.shape)}, "
            f"sgn {tuple(sgn.shape)} do not match"
        )
    if rows is not None:
        r0, r1 = (int(r) for r in rows)
        if pair_major or not 0 <= r0 < r1 <= n_b * h:
            raise ValueError(
                f"dense_assemble: rows {rows} is not a window of the {n_b * h} rows of "
                f"the [B H, B' H'] layout (pair_major={pair_major})"
            )
        rows = (r0, r1)
    if rowf.device.type == "cpu":
        return _dense_assemble_plain(table, pid, rowf, colf, sgn, diag, pair_major, rows)
    cdt = rowf.dtype
    if (cdt not in kernels.REAL_OF or any(t.dtype != cdt for t in (table, colf, diag))
            or sgn.dtype != kernels.REAL_OF[cdt]):
        raise TypeError(
            f"dense_assemble: dtypes table {table.dtype}, rowf {cdt}, colf {colf.dtype}, "
            f"diag {diag.dtype}, sgn {sgn.dtype}"
        )
    table, rowf, colf, diag, sgn = (
        t.contiguous() for t in (table, rowf, colf, diag, sgn))
    r0, r1 = (0, n_b * h) if rows is None else rows
    pairs = _pair_order(pid.to(rowf.device))  # [B * B, 3] or [K, B * B, 3]
    if rows is not None:
        pairs = _window_pairs(pairs, h, r0, r1)
    n_pairs = pairs.shape[-2]
    if pair_major:
        shape = (n_k, n_b, n_b, h, h)
    else:
        shape = (n_k, n_b, h, n_b, h) if rows is None else (n_k, r1 - r0, n_b, h)
    out = torch.empty(shape, dtype=cdt, device=rowf.device)
    # element strides of (b, b', h) in the output
    strides = (n_b * h * h, h * h, h) if pair_major else (h * n_b * h, h, n_b * h)
    dbl = cdt == torch.complex128
    vec = not dbl and h % 2 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (table, out))
    kernels.launch(
        "bhs_dense_assemble", table, pairs, 3 * n_pairs if pairs.ndim == 3 else 0, rowf,
        colf, sgn, diag, out, n_k, n_b, table.shape[1], h, n_pairs,
        _window_tiles(h, r0, r1, _KD_ROWS), *strides, out[0].numel(), r0, r1, int(vec),
        int(dbl),
    )
    dense_assemble.launches += 1
    return out


dense_assemble.launches = 0
