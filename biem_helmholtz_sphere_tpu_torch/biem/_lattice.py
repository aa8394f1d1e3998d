r"""Lattice-structured matrix-free operator: block convolution by FFT.

On a uniform square (or line) lattice of spheres the coupling of the BIEM
system is translation invariant: the off-diagonal block of the pair
(b, b') depends only on the cell offset n - m,

    coupling[n] = sum_{m != n} SR((n - m) s) (blc x)[m],

a 2D block convolution of the per-cell density with the kernel K[di, dj]
= SR((di sx, dj sy)).  It is evaluated by the convolution theorem: pad the
Lx x Ly cell grid to 2Lx x 2Ly, FFT the H-vector field over the cell
axes, multiply by the kernel's FFT per frequency ([H, H] @ [H]), inverse
FFT.  Nothing of size B^2 is formed, so the lattices of 1024-4096 spheres
of the `n_balls` accuracy family solve on one card.  The same semantics as
biem_helmholtz_sphere_tpu.biem._lattice, without its TPU workarounds (the
stacked real-pair product, the barrier on the offsets).  Its multi-card
form (the JAX package's `part` hooks, which leave the partitioning to
XLA) is `part`: explicit collectives of parallel.sharded_solve's ranks.

The kernel is built from the lexicographically positive half of the
offsets (`_core._offset_table`, the table of the dense and offset-table
routes: KG in 2D, K2 + the rotation sandwich in d >= 3); the other half
follows from the parity SR(-t) = pm pm^T .* SR(t), pm_h = (-1)^{n_h}.
Both halves are written by index into one zeroed [K, Fx, Fy, H, H] grid,
which `torch.fft.fftn` (cuFFT) transforms over the two cell axes a chunk
of rows at a time, back into the same buffer.  The
per-frequency product is one batched `torch.matmul` in native complex
(the JAX package leaves it to an XLA einsum outside any kernel).

Sharded over ranks (`part`, from parallel.sharded_solve(lattice=True)),
the kernel is built and stored by slabs.  Rank r takes a contiguous range
of the cell rows di of the positive half, builds the half table of those
offsets alone and writes it and its parity mirror into its rows of the
grid (di and -di mod Fx: a slab of ~Fx / world rows), FFTs them along Fy,
and one all_to_all re-slabs the grid by Fy columns, where it FFTs along
Fx: rank r keeps khat[:, :, Fy_r], ceil(Fy / world) columns.  Per matvec
every rank FFTs the small [K, Fx, Fy, H] vector field (replicated), takes
the product on its own columns (one batched `torch.matmul`), all-gathers
the columns and inverse-FFTs, replicated.
"""

import numpy as np
import torch

from ..harmonics._index import basis
from ..translation._rotation import unique_radii
from ._core import _offset_table, _radial_factors

# offsets per chunk of the parity mirror, and bytes per chunk of rows of
# the kernel's FFT (bound their temporaries)
_MIRROR_CHUNK = 256
_FFT_BYTES = 1 << 29


def lattice_routing(centers_np):
    """Detect a uniform (1- or 2-axis) lattice in host centers [B, d].

    Returns None, or (axes, spacings, shape, cell2ball, ball2cell) with
    ``centers[cell2ball[i * Ly + j]]`` the sphere at integer cell (i, j).
    A line is embedded as an L x 1 grid.  The JAX package's tolerances;
    the spacing is taken from the full span, so the kernel's offsets
    agree with the dense route's exact center differences.
    """
    centers_np = np.asarray(centers_np)
    if centers_np.ndim != 2:
        return None
    n_balls, d = centers_np.shape
    if n_balls < 4:
        return None  # the generic routes are already optimal for tiny systems
    spans = centers_np.max(axis=0) - centers_np.min(axis=0)
    scale = max(1.0, float(np.abs(centers_np).max()))
    tol = 1e-9 * scale
    axes = [a for a in range(d) if spans[a] > tol]
    if not 1 <= len(axes) <= 2:
        return None
    idx, shape, spacings = [], [], []
    for a in axes:
        vals = centers_np[:, a]
        v = np.unique(np.round(vals / tol) * tol)
        st = np.diff(v)
        if not np.all(np.abs(st - st[0]) <= 1e-6 * abs(st[0])):
            return None
        s_a = (vals.max() - vals.min()) / (len(v) - 1)
        v0 = vals.min()
        ii = np.round((vals - v0) / s_a)
        if not np.all(np.abs(vals - (v0 + ii * s_a)) <= 1e3 * tol):
            return None
        idx.append(ii.astype(np.int64))
        shape.append(len(v))
        spacings.append(float(s_a))
    if len(axes) == 1:  # embed a line as an L x 1 grid
        idx.append(np.zeros(n_balls, np.int64))
        shape.append(1)
        spacings.append(1.0)
        axes = [axes[0], axes[0]]
    if n_balls != shape[0] * shape[1]:
        return None
    flat = idx[0] * shape[1] + idx[1]  # ball -> cell
    if len(np.unique(flat)) != n_balls:
        return None
    cell2ball = np.empty(n_balls, np.int64)
    cell2ball[flat] = np.arange(n_balls)
    return axes, spacings, tuple(shape), cell2ball, flat


def _half_offsets(routing, d):
    """The lexicographically positive cell offsets (di, dj) of the lattice
    and their vectors [NOh, d] (host)."""
    axes, (sx, sy), (lx, ly), _, _ = routing
    dis, djs = np.meshgrid(np.arange(-(lx - 1), lx), np.arange(-(ly - 1), ly), indexing="ij")
    dis, djs = dis.ravel(), djs.ravel()
    pos = (dis > 0) | ((dis == 0) & (djs > 0))
    dis, djs = dis[pos], djs[pos]
    t = np.zeros((len(dis), d))
    t[:, axes[0]] += dis * sx
    t[:, axes[1]] += djs * sy
    return dis, djs, t


def _kernel_fft(c, n_end, routing, k, fold, method):
    """FFT of the block-convolution kernel: complex [K, Fx, Fy, H, H].

    The half table of the positive offsets (`_offset_table`, unscaled or
    with the ball-maximum exponents fold = (e_r, e_b) folded in) goes into
    its grid cells, its parity mirror into the negated cells, chunk by
    chunk; the (0, 0) cell and the padding stay zero.
    """
    _, _, (lx, ly), _, _ = routing
    fx, fy = 2 * lx, 2 * ly
    dis, djs, t = _half_offsets(routing, c.c_ndim)
    uniq_r, r_inv = unique_radii(np.linalg.norm(t, axis=1))
    half = _offset_table(c, n_end, t, uniq_r, r_inv, k, fold, method)  # [K, NOh, H, H]
    n_k, n_half, h_num = half.shape[:3]
    n_root = basis(c, n_end).n_root
    pm = torch.as_tensor((-1.0) ** (n_root % 2), dtype=k.real.dtype, device=half.device)
    parity = pm[:, None] * pm[None, :]
    dev = half.device
    cell_h = torch.as_tensor((dis % fx) * fy + (djs % fy), device=dev)
    cell_m = torch.as_tensor(((-dis) % fx) * fy + ((-djs) % fy), device=dev)
    grid = half.new_zeros((n_k, fx * fy, h_num, h_num))
    grid.index_copy_(1, cell_h, half)
    for s in range(0, n_half, _MIRROR_CHUNK):
        e = min(n_half, s + _MIRROR_CHUNK)
        grid.index_copy_(1, cell_m[s:e], half[:, s:e] * parity)
    del half
    grid = grid.view(n_k, fx, fy, h_num, h_num)
    # the FFT over the cell axes, a chunk of rows h' at a time, written back
    # in place: [K, Fx, Fy, H, H] stays one buffer, as the per-frequency
    # product reads it
    rows = max(1, _FFT_BYTES // (n_k * fx * fy * h_num * grid.element_size()))
    for r in range(0, h_num, rows):
        grid[:, :, :, r : r + rows] = torch.fft.fftn(grid[:, :, :, r : r + rows], dim=(1, 2))
    return grid


def _slab_rows(lx, world, rank):
    """(di, rows): rank's contiguous share di of the half offsets' cell
    rows 0 <= di < lx, and the grid rows (Fx = 2 lx) it holds while the
    kernel is built, those and their mirrors -di mod Fx (the padding row
    lx is nobody's: it stays zero)."""
    di = np.array_split(np.arange(lx), world)[rank]
    return di, np.unique(np.concatenate([di, (-di) % (2 * lx)])).astype(np.int64)


def _columns(fy, world, rank):
    """The Fy columns [c0, c1) that rank keeps of the kernel's FFT:
    ceil(Fy / world) each, the last ranks fewer (or none)."""
    per = -(-fy // world)
    return min(fy, rank * per), min(fy, (rank + 1) * per)


def _kernel_fft_part(c, n_end, routing, k, fold, method, part):
    """This rank's columns of the kernel's FFT: complex [Fy_r, Fx, K, H, H],
    Fy_r = the columns of `_columns`, built by slabs (module docstring)."""
    _, _, (lx, ly), _, _ = routing
    fx, fy = 2 * lx, 2 * ly
    world, rank = part.world, part.rank
    dis, djs, t = _half_offsets(routing, c.c_ndim)
    di_mine, rows = _slab_rows(lx, world, rank)
    mine = np.isin(dis, di_mine)  # this rank's half offsets
    dis, djs, t = dis[mine], djs[mine], t[mine]
    n_k, h_num = k.shape[0], basis(c, n_end).num
    cdt = torch.complex128 if k.real.dtype == torch.float64 else torch.complex64
    dev = k.device
    # the slab [Fy, rows, K, H, H]: Fy outermost, so each destination's
    # columns are one contiguous piece of it for the all_to_all
    slab = torch.zeros((fy, len(rows), n_k, h_num, h_num), dtype=cdt, device=dev)
    if len(dis):
        uniq_r, r_inv = unique_radii(np.linalg.norm(t, axis=1))
        half = _offset_table(c, n_end, t, uniq_r, r_inv, k, fold, method)  # [K, NOh_r, H, H]
        pm = torch.as_tensor((-1.0) ** (basis(c, n_end).n_root % 2), dtype=k.real.dtype,
                             device=dev)
        parity = pm[:, None] * pm[None, :]
        pos = np.searchsorted(rows, np.arange(fx))  # grid row -> slab row (its rows)
        cell_h = torch.as_tensor((djs % fy) * len(rows) + pos[dis % fx], device=dev)
        cell_m = torch.as_tensor(((-djs) % fy) * len(rows) + pos[(-dis) % fx], device=dev)
        flat = slab.view(fy * len(rows), n_k, h_num, h_num)
        flat.index_copy_(0, cell_h, half.transpose(0, 1))
        for s in range(0, len(dis), _MIRROR_CHUNK):
            e = min(len(dis), s + _MIRROR_CHUNK)
            flat.index_copy_(0, cell_m[s:e], (half[:, s:e] * parity).transpose(0, 1))
        del half
    chunk = max(1, _FFT_BYTES // max(1, slab[:, :, :, :1].numel() * slab.element_size()))
    for r in range(0, h_num, chunk):  # along Fy, a chunk of rows h at a time
        slab[:, :, :, r : r + chunk] = torch.fft.fft(slab[:, :, :, r : r + chunk], dim=0)
    # re-slab by Fy columns: every rank's rows of my columns, in one all_to_all
    block = n_k * h_num * h_num
    c0, c1 = _columns(fy, world, rank)
    col_n = [np.subtract(*_columns(fy, world, s)[::-1]) for s in range(world)]
    row_sets = [_slab_rows(lx, world, s)[1] for s in range(world)]
    recv = slab.new_empty(((c1 - c0) * sum(len(rs) for rs in row_sets) * block,))
    part.all_to_all(recv, slab.view(-1), [int((c1 - c0) * len(rs) * block) for rs in row_sets],
                    [int(n * len(rows) * block) for n in col_n])
    del slab
    khat = recv.new_zeros((c1 - c0, fx, n_k, h_num, h_num))
    at = 0
    for rs in row_sets:
        n = (c1 - c0) * len(rs) * block
        khat.index_copy_(1, torch.as_tensor(rs, device=dev),
                         recv[at : at + n].view(c1 - c0, len(rs), n_k, h_num, h_num))
        at += n
    del recv
    chunk = max(1, _FFT_BYTES // max(1, khat[..., :1, :].numel() * khat.element_size()))
    for r in range(0, h_num, chunk):  # along Fx
        khat[..., r : r + chunk, :] = torch.fft.fft(khat[..., r : r + chunk, :], dim=1)
    return khat


def lattice_operator(c, n_end, centers_np, radii, k, eta, alpha, beta, method=None,
                     stable=False, part=None):
    """(mv, diag) on [K, B*H] vectors for a lattice geometry.

    The same contract as `_core._matfree_operator`: mv applies the full
    system matrix, diag is its diagonal.  stable=True builds the kernel
    scale-compensated with the ball-maximum exponents folded in, the
    per-ball deficits on the row and column factors (`_radial_factors`).
    centers_np [B, d] on the host; radii/alpha/beta [K, B], k/eta [K].

    part (parallel.sharded_solve(lattice=True); rank, world, all_gather,
    all_to_all) shards the kernel's build and store over the ranks (the
    module docstring); the result is replicated on every rank and
    mv.stored_bytes is this rank's kernel.

    A block-circulant (Strang) preconditioner is not built: the JAX
    package measured it counterproductive (64 spheres: 150 against 136
    Jacobi-preconditioned GMRES steps; 256: 2459 against 454), as the
    Hankel kernel decays too slowly for circulant aliasing to be benign.
    """
    routing = lattice_routing(centers_np)
    if routing is None:
        raise ValueError("lattice_operator: the centers do not form a lattice")
    _, _, (lx, ly), cell2ball, ball2cell = routing
    fx, fy = 2 * lx, 2 * ly
    n_k, n_balls = radii.shape
    h_num = basis(c, n_end).num
    rowf, colf, diag, fold = _radial_factors(c, n_end, radii, k, eta, alpha, beta, stable)
    if part is not None:
        return _sharded_operator(c, n_end, routing, radii, k, rowf, colf, diag, fold, method,
                                 part)
    khat = _kernel_fft(c, n_end, routing, k, fold, method)
    khat = khat.view(n_k * fx * fy, h_num, h_num)
    dev = radii.device
    c2b = torch.as_tensor(cell2ball, device=dev)
    b2c = torch.as_tensor(ball2cell, device=dev)
    rowf, colf, diag = (t.expand(n_k, n_balls, h_num).contiguous() for t in (rowf, colf, diag))
    padded = colf.new_zeros((n_k, fx, fy, h_num))  # reused; the gap stays zero

    def mv(x_flat):
        x = x_flat.reshape(n_k, n_balls, h_num)
        padded[:, :lx, :ly] = (colf * x).index_select(1, c2b).view(n_k, lx, ly, h_num)
        zhat = torch.fft.fftn(padded, dim=(1, 2))
        yhat = torch.matmul(khat, zhat.reshape(n_k * fx * fy, h_num, 1))  # per frequency
        y = torch.fft.ifftn(yhat.view(n_k, fx, fy, h_num), dim=(1, 2))[:, :lx, :ly]
        cpl = y.reshape(n_k, lx * ly, h_num).index_select(1, b2c)
        out = diag * x + rowf * cpl
        return out.reshape(n_k, n_balls * h_num)

    return mv, diag.reshape(n_k, n_balls * h_num)


def _sharded_operator(c, n_end, routing, radii, k, rowf, colf, diag, fold, method, part):
    """`lattice_operator` over part's ranks: this rank's columns of the
    kernel, the product on them, the columns all-gathered."""
    _, _, (lx, ly), cell2ball, ball2cell = routing
    fx, fy = 2 * lx, 2 * ly
    n_k, n_balls = radii.shape
    h_num = basis(c, n_end).num
    dev = radii.device
    khat = _kernel_fft_part(c, n_end, routing, k, fold, method, part)  # [Fy_r, Fx, K, H, H]
    c0, c1 = _columns(fy, part.world, part.rank)
    per = -(-fy // part.world)
    c2b = torch.as_tensor(cell2ball, device=dev)
    b2c = torch.as_tensor(ball2cell, device=dev)
    rowf, colf, diag = (t.expand(n_k, n_balls, h_num).contiguous() for t in (rowf, colf, diag))
    padded = colf.new_zeros((n_k, fx, fy, h_num))
    mine = colf.new_zeros((per, fx, n_k, h_num))  # my columns' product, padded to per

    def mv(x_flat):
        x = x_flat.reshape(n_k, n_balls, h_num)
        padded[:, :lx, :ly] = (colf * x).index_select(1, c2b).view(n_k, lx, ly, h_num)
        zhat = torch.fft.fftn(padded, dim=(1, 2))  # [K, Fx, Fy, H], on every rank
        z = zhat[:, :, c0:c1].permute(2, 1, 0, 3)[..., None]  # [Fy_r, Fx, K, H, 1]
        mine[: c1 - c0] = torch.matmul(khat, z)[..., 0]
        yhat = part.all_gather(mine)[:fy]  # [Fy, Fx, K, H]
        y = torch.fft.ifftn(yhat.permute(2, 1, 0, 3), dim=(1, 2))[:, :lx, :ly]
        cpl = y.reshape(n_k, lx * ly, h_num).index_select(1, b2c)
        out = diag * x + rowf * cpl
        return out.reshape(n_k, n_balls * h_num)

    mv.stored_bytes = khat.numel() * khat.element_size()
    return mv, diag.reshape(n_k, n_balls * h_num)
