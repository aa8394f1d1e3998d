r"""Rotation + coaxial (S|R) translation for 'b'-rooted trees.

    SR(t) = D(R) SR_e(|t|) D(R)^H,        R e = t^

*  `SR_e(r)`, translation along the root axis, is block-diagonal over the
   child states; its host index vectors come from `_coax_index`, its root
   tables from `_coax_tables_on` (built on the device), and the
   scale-compensated band sum lives in `_scaled.coaxial_scaled`.
*  `D(R)`, the harmonic representation of the rotation R, preserves
   degree (block-diagonal over degrees), is unitary, and is computed
   exactly by quadrature: D[h',h] = sum_q w_q conj(Y_{h'}(s_q))
   Y_h(R^{-1} s_q), with a rule exact to degree 2(n_end-1).

*  `coaxial_sr`, the unscaled band sum of SR_e (or RR_e) at radius r, runs
   the K2 kernel with zero exponents: its group scales and fold factor are
   then exactly 1, so it writes the unscaled values at the packed entries.
*  `sr_rotation` = D X D^H per offset, with X computed once per distinct
   |t| (`unique_radii`); `_sandwich` multiplies by D's degree groups only
   (~9x fewer multiply-adds than full [H, H] products at n_end = 32).  D
   is cached per set of offsets (`rotation_d`), in the degree-group form
   of the sandwich and the packed form of the factored matvec (KB).

The same math as biem_helmholtz_sphere_tpu.translation._rotation; the
host index vectors are numpy, built once per (tree, n_end) and cached, and
everything O(H q) or larger is built on the device.
"""

from dataclasses import replace
from functools import cached_property, lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..coords import from_cartesian, to_cartesian
from ..harmonics._eval import _node_table, harmonics
from ..harmonics._index import _child_states, _zonal_jobs, basis, harm_n_ndim
from ..harmonics._quad import _node_rule, sphere_quadrature
from ..ops import kernels
from ..ops.block_diag import pack_layout, unpack
from ..ops.harmonic_program import harmonic_program, program_numpy
from ..ops.kernels import REAL_OF
from ..special._family import spherical_jh_all
from ._ops import _a_const, _surface_area, _unit_offsets, ipow


def _root_axis(c):
    if c.root.kind not in ("b", "bp"):
        raise ValueError(
            "rotation translation requires a 'b'/'bp'-rooted tree "
            f"(got {c.root.kind!r})"
        )
    return c.root.axis


@lru_cache(maxsize=32)
def _coax_index(c, n_end):
    """The coaxial factor's host index vectors (numpy, cached per (tree,
    n_end)): (zf [NB] zonal prefactors, th [q] and w [q] the root rule's
    angles and weights, ell [H] root degree, cs [H] child-state id).
    Nothing here enumerates the basis at 2 n_end - 1: the zonal jobs come
    from `_zonal_jobs`."""
    _root_axis(c)
    b = basis(c, n_end)
    root = c.root
    nid = root.nid
    th, w = _node_rule(root, 4 * (n_end - 1) + 2)
    ell = np.asarray([p[1] for p in b.node_jobs[nid]], dtype=np.int64)[b.node_job_index[nid]]
    # Y_{(n'',0)}(z^) and conj(Y_{(n'',0)}(s^)) each carry 1/sqrt(omega_child)
    tz0 = _node_table(root, _zonal_jobs(c, n_end), {nid: torch.zeros(1, dtype=torch.float64)})
    zf = tz0.numpy()[0] / _surface_area(root.children[0].sdim + 1)
    return zf, th, w, ell, _child_states(c, n_end)


def _coax_root(c, n_end, device):
    """The root factors at the rule's nodes, float64 on `device`: (t_cols
    [q, H] of each harmonic, tz [q, NB] of the zonal jobs (0, n''))."""
    th = _coax_index(c, n_end)[1]
    b = basis(c, n_end)
    root = c.root
    ang = {root.nid: torch.as_tensor(th, dtype=torch.float64, device=device)}
    t_tab = _node_table(root, b.node_jobs[root.nid], ang)  # [q, J]
    idx = torch.as_tensor(b.node_job_index[root.nid], dtype=torch.int64, device=device)
    return t_tab[:, idx], _node_table(root, _zonal_jobs(c, n_end), ang)


@lru_cache(maxsize=8)
def _coax_tables_on(c, n_end, device):
    """KU's root tables, built on `device` in float64 and cached per (tree,
    n_end, device): t [H, q] (the root factors transposed: one harmonic's
    nodes contiguous) and tz w [q, NB]."""
    t_cols, tz = _coax_root(c, n_end, device)
    w = torch.as_tensor(_coax_index(c, n_end)[2], dtype=torch.float64, device=device)
    return t_cols.T.contiguous(), (tz * w[:, None]).contiguous()


@lru_cache(maxsize=32)
def _coax_tables(c, n_end):
    """The coaxial factor's tables as host numpy, the JAX package's six:
    (zf [NB] zonal prefactors, w [q] quadrature weights, tz [q, NB] zonal
    root factors, t_cols [q, H] root factors per harmonic, ell [H] root
    degree, cs [H] child-state id), from `_coax_index` and the root factors
    on the CPU."""
    zf, _, w, ell, cs = _coax_index(c, n_end)
    t_cols, tz = _coax_root(c, n_end, "cpu")
    return zf, w, tz.numpy(), t_cols.numpy(), ell, cs


@lru_cache(maxsize=256)
def _degree_groups(c, n_end, target=128):
    """Contiguous [start, stop) row groups aligned to root-degree-block
    boundaries, each <= target rows where block sizes allow (a single
    block larger than target becomes its own group)."""
    n_root = np.asarray(basis(c, n_end).n_root)
    bounds = [0] + [
        i for i in range(1, len(n_root)) if n_root[i] != n_root[i - 1]
    ] + [len(n_root)]
    groups = []
    start = 0
    for bi in range(1, len(bounds) - 1):
        if bounds[bi + 1] - start > target and bounds[bi] > start:
            groups.append((start, bounds[bi]))
            start = bounds[bi]
    groups.append((start, bounds[-1]))
    return tuple(groups)


@lru_cache(maxsize=8)
def _rot_tables_on(c, n_end, device):
    """The rotation's quadrature tables built on `device` in plain torch
    float64: (weights [Q], conj(Y) [Q, H] complex128, unit points [d, Q],
    root degrees [H]), cached per (tree, n_end, device).  The rule's nodes
    per tree node come from the host (`sphere_quadrature`, one small rule
    each); the harmonics and the cartesian points are evaluated on the
    device."""
    sph, w = sphere_quadrature(c, 2 * (n_end - 1))
    sph_t = {key: torch.as_tensor(v, dtype=torch.float64, device=device) for key, v in sph.items()}
    return (torch.as_tensor(w, dtype=torch.float64, device=device),
            harmonics(c, sph_t, n_end).conj_physical_(),
            to_cartesian(c, sph_t, include_r=False),
            torch.as_tensor(basis(c, n_end).n_root, dtype=torch.int64, device=device))


@lru_cache(maxsize=32)
def _rot_tables(c, n_end):
    """`_rot_tables_on` the CPU, as host numpy (the plain version's)."""
    return tuple(a.numpy() for a in _rot_tables_on(c, n_end, "cpu"))


# K3's shapes (csrc/rotation_blocks.cu): nodes a chunk; rows of one CTA's
# share of a degree block; a ring stage's lines (a line: one row of conj(Y)
# w or one column of harmonics, at a chunk's nodes), by complex128; the
# consumer threads; the bytes of one slab of the harmonics at the rotated
# nodes (every direction and harmonic at a run of nodes)
_K3_KQ = 32
_K3_RMAX = 64
_K3_LINES = {False: 280, True: 128}
_K3_LINE = {False: 34, True: 36}  # a line's stride: 32 nodes, then padding
_K3_THREADS = 256
_K3_SCRATCH = 2 << 30


@lru_cache(maxsize=32)
def _k3_layout(c, n_end):
    """(src [hp], op [n_end]): K3's rows of conj(Y) w, each root-degree block
    n at rows op[n].. and padded with rows of zeros (src -1, else the flat
    harmonic of the row) to a multiple of 8."""
    src, op = [], []
    o = 0
    for n in range(n_end):
        g = harm_n_ndim(n, c.c_ndim)
        op.append(len(src))
        src.extend(range(o, o + g))
        src.extend([-1] * (-g % 8))
        o += g
    return np.asarray(src), np.asarray(op)


@lru_cache(maxsize=8)
def _rot_ycw(c, n_end, dtype, device):
    """K3's inputs on `device`, cached: conj(Y) w in the complex dtype
    `dtype`, chunk-major [qp / 32, hp, line] (rows by `_k3_layout`, each
    row's 32 nodes of a chunk in a line of `_K3_LINE` values, as in K3's
    shared memory, zero on the padding rows, nodes and line ends: a CTA's
    rows of a chunk are one bulk copy), and the unit points [d, Q] in its
    real dtype."""
    w, yc, s_cart, _ = _rot_tables_on(c, n_end, device)
    src, _ = _k3_layout(c, n_end)
    q_num = w.shape[0]
    n_chunks = -(-q_num // _K3_KQ)
    out = torch.zeros((n_chunks, len(src), _K3_LINE[dtype == torch.complex128]), dtype=dtype,
                      device=device)
    keep = np.nonzero(src >= 0)[0]
    rows = torch.zeros((len(keep), n_chunks * _K3_KQ), dtype=dtype, device=device)
    rows[:, :q_num] = (yc * w[:, None]).to(dtype).T[torch.as_tensor(src[keep], device=device)]
    out[:, torch.as_tensor(keep, device=device), :_K3_KQ] = (
        rows.view(len(keep), n_chunks, _K3_KQ).transpose(0, 1))
    return out, s_cart.to(REAL_OF[dtype]).contiguous()


class _K3Plan(NamedTuple):
    """K3's host tables, built once per (tree, n_end, dtype).

    * `info` [n_blocks, 10] int32: the BlockInfo of each root-degree block:
      offset o, size g, its degree group's size G, its row in the group,
      its first row in `_rot_ycw`'s layout, the columns W of each of its
      CTAs, then as int64 the group's entries per direction before it and
      its packed offset;
    * `shares` per block: its rows cut into CTA shares of at most 64, each
      (first row, rows), a multiple of 8 but the last;
    * `nnz` the packed entries and `g_all` the degree groups' entries per
      direction.
    """

    info: np.ndarray
    shares: tuple
    nnz: int
    g_all: int


def _k3_width(octs, double):
    """The columns W of a CTA whose share of a block has at most octs x 8
    rows: as many as its consumers' tiles hold (complex64: 256 threads of
    8 x 4 entries; complex128: 8 warps of 4 slots of 16 columns x 8 rows)
    and a ring stage's lines allow."""
    if double:
        return 16 * min(32 // octs, (_K3_LINES[True] - 8 * octs) // 16)
    return 4 * min(_K3_THREADS // octs, (_K3_LINES[False] - 8 * octs) // 4)


@lru_cache(maxsize=32)
def _k3_plan(c, n_end, double):
    """K3's host tables (`_K3Plan`) for complex128 (double) or complex64."""
    groups = _degree_groups(c, n_end)
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    g_pre = np.concatenate([[0], np.cumsum([(e - s) ** 2 for s, e in groups])])
    v_off = np.concatenate([[0], np.cumsum(np.square(sizes))])
    _, op = _k3_layout(c, n_end)
    ints, longs, shares = [], [], []
    for n, g in enumerate(sizes):
        o = int(offs[n])
        gi = next(i for i, (s, e) in enumerate(groups) if s <= o < e)
        s, e = groups[gi]
        # rows in shares of at most 64 (8-row octets), cut evenly
        n_oct = -(-g // 8)
        n_parts = -(-n_oct // (_K3_RMAX // 8))
        octs = [n_oct // n_parts + (k < n_oct % n_parts) for k in range(n_parts)]
        r = 8 * np.concatenate([[0], np.cumsum(octs)])
        shares.append(tuple((int(r[k]), int(min(r[k + 1], g) - r[k])) for k in range(n_parts)))
        ints.append((o, g, e - s, o - s, int(op[n]), _k3_width(max(octs), double)))
        longs.append((g_pre[gi], v_off[n]))
    info = np.concatenate([np.asarray(ints, dtype=np.int32).view(np.int64),
                           np.asarray(longs, dtype=np.int64)], axis=1)
    return _K3Plan(info.view(np.int32), tuple(shares), int(v_off[-1]), int(g_pre[-1]))


@lru_cache(maxsize=32)
def _k3_jobs(c, n_end, double, n_dir):
    """K3's CTAs at n_dir directions, desc [n_cta, 4] int32: a degree
    block's columns of every direction side by side (column n g + j is
    direction n's column j: conj(Y) w is the same for every direction),
    cut into strips of W columns; a CTA per strip and share of its rows:
    block, the strip's first column, the share's first row and rows (the
    largest blocks first)."""
    plan = _k3_plan(c, n_end, double)
    desc = [(blk, c0, r0, nr)
            for blk in sorted(range(len(plan.info)), key=lambda b: -plan.info[b, 1])
            for c0 in range(0, n_dir * int(plan.info[blk, 1]), int(plan.info[blk, 5]))
            for r0, nr in plan.shares[blk]]
    return np.ascontiguousarray(desc, dtype=np.int32).reshape(-1, 4)


def _k3_slab(n_dir, h_num, q_pad, double):
    """Nodes a slab of K3's harmonics at the rotated nodes holds: a multiple
    of 64 (two chunks: the sums' first level) within `_K3_SCRATCH` bytes of
    [slab / 32, N, H, line] values, or all q_pad nodes."""
    per_chunk = n_dir * h_num * _K3_LINE[double] * (16 if double else 8)
    return min(q_pad, max(64, _K3_SCRATCH // per_chunk // 2 * 64))


def _k3_ratios(c, n_end, double, n_dir):
    """K3's plan at n_dir directions, counted: (product entries computed /
    entries needed, harmonic generations per direction / H).  A CTA
    computes its share's rows to a multiple of 8 and its strip's columns to
    the consumers' step (4 in complex64, 16 in complex128); the harmonics
    pass writes each program entry of each direction once at each node."""
    plan = _k3_plan(c, n_end, double)
    desc = _k3_jobs(c, n_end, double, n_dir)
    g, w = plan.info[desc[:, 0], 1].astype(np.int64), plan.info[desc[:, 0], 5]
    wu = np.minimum(w, n_dir * g - desc[:, 1])
    step = 16 if double else 4
    done = (-(-desc[:, 3] // 8) * 8) * (-(-wu // step) * step)
    needed = n_dir * sum(int(x) ** 2 for x in plan.info[:, 1])
    h_num = int(plan.info[:, 1].sum())
    return float(done.sum()) / needed, len(program_numpy(c, n_end)["perm"]) / h_num


def _rotation_blocks_k3(c, dirs, n_end):
    """K3 on CUDA directions dirs [N, d]: (groups, blocks [N, g, g] per
    degree group, packed values [N, nnz]), one launch (`rotation_blocks.
    launches`)."""
    d = c.c_ndim
    rdt, dev = dirs.dtype, dirs.device
    cdt = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(rdt)
    if cdt is None:
        raise TypeError(f"rotation_blocks: directions of dtype {rdt}")
    double = cdt == torch.complex128
    ycw, s_cart = _rot_ycw(c, n_end, cdt, dev)
    prog = harmonic_program(c, n_end, rdt, dev)
    plan = _k3_plan(c, n_end, double)
    n_dir = dirs.shape[0]
    rot = _rotation_to_axis(dirs, _root_axis(c), d).contiguous()
    grp = torch.zeros(n_dir * plan.g_all, dtype=cdt, device=dev)
    packed = torch.empty((n_dir, plan.nnz), dtype=cdt, device=dev)
    if n_dir:
        desc = _k3_jobs(c, n_end, double, n_dir)
        _k3_launch(ycw, s_cart, rot, prog, _k3_tables(c, n_end, double, dev),
                   torch.as_tensor(desc, device=dev), grp, packed)
    groups = _degree_groups(c, n_end)
    blocks, pos = [], 0
    for s, e in groups:
        g = e - s
        blocks.append(grp[pos : pos + n_dir * g * g].view(n_dir, g, g))
        pos += n_dir * g * g
    return groups, blocks, packed


def _k3_launch(ycw, s_cart, rot, prog, info, desc, grp, packed):
    """One K3 launch (counted in `rotation_blocks.launches`): its C entry
    runs, slab by slab of nodes, the harmonics at the rotated nodes into a
    scratch, then the CTAs of `desc`, which add the slab's sums to D."""
    (n_chunks, h_pad, line), (n_dir, nnz), (d, q_num) = ycw.shape, packed.shape, s_cart.shape
    double = s_cart.dtype == torch.float64
    slab = _k3_slab(n_dir, prog.h_num, n_chunks * _K3_KQ, double)
    harm = torch.empty(slab // _K3_KQ * n_dir * prog.h_num * line, dtype=ycw.dtype,
                       device=ycw.device)
    kernels.launch("bhs_rotation_blocks", ycw, s_cart, rot, prog.nodes, prog.jobs, prog.fam,
                   prog.coef, prog.famr, prog.n_nodes, prog.cs, prog.csjob, prog.perm, prog.n_cs,
                   info, desc, desc.shape[0], harm, slab, grp, packed, n_dir, q_num,
                   n_chunks * _K3_KQ, h_pad, prog.h_num, d, nnz, int(double))
    rotation_blocks.launches += 1


@lru_cache(maxsize=32)
def _k3_tables(c, n_end, double, device):
    """`_k3_plan`'s block table on `device`."""
    return torch.as_tensor(_k3_plan(c, n_end, double).info, device=device).contiguous()


def _rotation_to_axis(t_hat, axis, d):
    """R with R e_axis = t_hat, as a [..., d, d] matrix (Rodrigues in the
    plane span(e_axis, t_hat); safe at t_hat = +-e_axis)."""
    kw = dict(dtype=t_hat.dtype, device=t_hat.device)
    e = torch.zeros(d, **kw)
    e[axis] = 1.0
    ct = t_hat[..., axis]
    v = t_hat - ct[..., None] * e
    s = torch.linalg.norm(v, dim=-1)
    safe = s > 1e-7
    v_hat = torch.where(
        safe[..., None], v / torch.where(safe, s, torch.ones_like(s))[..., None],
        torch.zeros_like(v),
    )
    eye = torch.eye(d, **kw)
    uu = e[:, None] * e[None, :]
    vv = v_hat[..., :, None] * v_hat[..., None, :]
    vu = v_hat[..., :, None] * e[None, :]
    uv = e[:, None] * v_hat[..., None, :]
    r = eye + (ct[..., None, None] - 1.0) * (uu + vv) + s[..., None, None] * (vu - uv)
    # t_hat ~ -e: rotate by pi in the (e, e_other) plane
    anti = (~safe) & (ct < 0)
    other = (axis + 1) % d
    flip = torch.eye(d, **kw)
    flip[axis, axis] = -1.0
    flip[other, other] = -1.0
    r = torch.where(anti[..., None, None], flip, r)
    # t_hat ~ +e: identity
    return torch.where(((~safe) & (ct >= 0))[..., None, None], eye, r)


# bytes of one chunk's [chunk, Q, H] complex harmonics at the rotated nodes
# and their temporaries in `rotation_blocks` (as `_eval._EVAL_BYTES` bounds
# the field evaluation's)
_ROT_BYTES = 1 << 30
# [chunk, Q, H]-sized complex tensors alive at once while the harmonics are
# evaluated (one node's gathered factors, the running product, the result)
_ROT_TEMPS = 4


def rotation_blocks(c, t_hat, n_end):
    """D(R) as degree-group diagonal blocks: (groups, [complex [..., g, g]]).

    On CUDA tensors K3 (`csrc/rotation_blocks.cu`, `_rotation_blocks_k3`);
    on CPU tensors its plain version `_rotation_blocks_plain`.
    """
    groups, blocks, _ = _rotation_blocks_any(c, t_hat, n_end)
    return groups, blocks


def _rotation_blocks_any(c, t_hat, n_end):
    """`rotation_blocks` and, from K3, the packed blocks [..., nnz] it also
    writes (None from the plain version)."""
    if t_hat.device.type == "cpu":
        return _rotation_blocks_plain(c, t_hat, n_end) + (None,)
    if t_hat.device.type != "cuda":
        raise RuntimeError(f"rotation_blocks: unsupported device {t_hat.device}")
    groups, blocks, vals = _rotation_blocks_k3(c, t_hat.reshape(-1, c.c_ndim), n_end)
    batch = t_hat.shape[:-1]
    return (groups, [b.view(batch + b.shape[-2:]) for b in blocks],
            vals.view(batch + vals.shape[-1:]))


rotation_blocks.launches = 0


def _rotation_blocks_plain(c, t_hat, n_end):
    """K3's plain version: D(R) as degree-group diagonal blocks.

    The harmonics at the rotated nodes are evaluated for a chunk of
    directions at a time, sized so that the chunk's [chunk, Q, H] values
    and their temporaries stay within _ROT_BYTES, and each degree group is
    contracted per chunk (the chunking does not change a direction's
    arithmetic).  Within a group that spans several degree blocks the
    quadrature's ~eps off-block residue is masked to exact zeros:
    sandwiched against coax blocks of magnitude |h_{n+n'}(kr)| it would
    leak huge-scale roundoff into low-degree entries (0.23 relative error
    in float32 at n_end=10).
    """
    d = c.c_ndim
    axis = _root_axis(c)
    w, yc, s_cart, n_root = _rot_tables(c, n_end)
    kw = dict(dtype=t_hat.dtype, device=t_hat.device)
    cdt = torch.complex128 if t_hat.dtype == torch.float64 else torch.complex64
    ycw = torch.as_tensor(yc, dtype=cdt, device=t_hat.device) * torch.as_tensor(w, **kw)[:, None]
    s_cart = torch.as_tensor(s_cart, **kw)
    batch = t_hat.shape[:-1]
    dirs = t_hat.reshape(-1, d)
    q_num, h_num = yc.shape
    per_dir = _ROT_TEMPS * q_num * h_num * ycw.element_size()
    chunk = max(1, _ROT_BYTES // per_dir)
    groups = _degree_groups(c, n_end)
    parts = [[] for _ in groups]
    for i0 in range(0, dirs.shape[0], chunk):
        r = _rotation_to_axis(dirs[i0 : i0 + chunk], axis, d)  # [n, d, d]
        s_rot = torch.einsum("nij,iq->njq", r, s_cart)  # R^T s
        y_rot = harmonics(c, from_cartesian(c, torch.movedim(s_rot, -2, 0)), n_end)  # [n, Q, H]
        for part, (s, e) in zip(parts, groups):
            part.append(torch.einsum("qa,nqb->nab", ycw[:, s:e], y_rot[..., s:e]))
        del y_rot
    blocks = []
    for part, (s, e) in zip(parts, groups):
        dmat_g = torch.cat(part).reshape(batch + (e - s, e - s))
        nr_g = n_root[s:e]
        if nr_g[0] != nr_g[-1]:  # group spans several degree blocks
            same = torch.as_tensor(nr_g[:, None] == nr_g[None, :], device=t_hat.device)
            dmat_g = torch.where(same, dmat_g, 0.0)
        blocks.append(dmat_g)
    return groups, blocks


def rotation_matrix(c, t_hat, n_end):
    """D(R)[..., h', h] with R e_root = t_hat: unitary, degree-block-
    diagonal, exact zeros off the degree groups."""
    groups, blocks = rotation_blocks(c, t_hat, n_end)
    h_num = groups[-1][1]
    out = blocks[0].new_zeros(blocks[0].shape[:-2] + (h_num, h_num))
    for (s, e), blk in zip(groups, blocks):
        out[..., s:e, s:e] = blk
    return out


class RotationD:
    """D(R) of a set of offset directions, in the two forms its users read:
    `groups` / `blocks` (`rotation_blocks`, the sandwich's) and `packed`
    (the degree blocks as a BlockDiag, KB's): written by K3 beside the
    groups on the card, built from them at first use on the CPU."""

    def __init__(self, c, t_hat, n_end):
        self.sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
        self.groups, self.blocks, vals = _rotation_blocks_any(c, t_hat, n_end)
        if vals is not None:  # K3 wrote both forms
            lay = pack_layout(self.sizes, None, sum(self.sizes), t_hat.device)
            self.__dict__["packed"] = replace(lay, vals=vals)

    @cached_property
    def packed(self):
        """The degree blocks (harm_n_ndim(n, d) rows each) taken straight
        from the groups into the packed layout: equal, value for value, to
        `pack` of the dense D, without forming it."""
        offs = np.concatenate([[0], np.cumsum(self.sizes)])
        vals = []
        for (s, e), blk in zip(self.groups, self.blocks):
            for n in np.nonzero((offs[:-1] >= s) & (offs[:-1] < e))[0]:
                o = offs[n] - s
                g = self.sizes[n]
                vals.append(blk[..., o : o + g, o : o + g].reshape(blk.shape[:-2] + (g * g,)))
        lay = pack_layout(self.sizes, None, int(offs[-1]), self.blocks[0].device)
        return replace(lay, vals=torch.cat(vals, dim=-1))


@lru_cache(maxsize=4)
def _rotation_d(c, n_end, t_bytes, shape, dtype, device):
    t_vec = torch.as_tensor(np.frombuffer(t_bytes, dtype=np.float64).reshape(shape).copy(),
                            dtype=dtype, device=device)
    r = torch.linalg.vector_norm(t_vec, dim=-1, keepdim=True)
    return RotationD(c, t_vec / torch.where(r > 0, r, torch.ones_like(r)), n_end)


def rotation_d(c, n_end, t_np, dtype, device):
    """RotationD of host offset vectors t_np [..., d], normalised in `dtype`
    on `device`; cached on their values (a geometry's offsets recur on
    every k-block of a sweep, on the factored and the dense routes)."""
    t = np.ascontiguousarray(t_np, dtype=np.float64)
    return _rotation_d(c, n_end, t.tobytes(), t.shape, dtype, torch.device(device))


def _coaxial_sr_plain(c, rad, n_end):
    """Plain version of `coaxial_sr` from the band values rad [..., NB]
    (h_n(k r) for SR, j_n(k r) for RR, n < 2 n_end - 1): the JAX package's
    dense formula sum_n i^n a_d zf_n rad_n U_n, times i^{l'} conj(i^l),
    masked to the child-state blocks.  Complex [..., H, H]."""
    from ._scaled import _coax_bands

    zf, _, _, ell, cs = _coax_index(c, n_end)
    n_bands = 2 * n_end - 1
    rdt, dev = rad.real.dtype, rad.device
    u = _coax_bands(c, n_end, rdt, dev).flatten(0, 1)[:n_bands]  # [NB, H, H]
    coef = ipow(np.arange(n_bands), rad.dtype, dev) * torch.as_tensor(
        _a_const(c.c_ndim) * zf, dtype=rdt, device=dev) * rad
    h_num = u.shape[-1]
    flat = coef.reshape(-1, n_bands)
    m = torch.complex(flat.real @ u.reshape(n_bands, -1), flat.imag @ u.reshape(n_bands, -1))
    m = m.reshape(coef.shape[:-1] + (h_num, h_num))
    p = ipow(torch.as_tensor(ell, device=dev), rad.dtype, dev)
    same_cs = torch.as_tensor(cs[:, None] == cs[None, :], device=dev)
    return torch.where(same_cs, (m * p[:, None]) * p.conj()[None, :], 0.0)


def coaxial_sr(c, r, n_end, k, kind="SR"):
    """SR (or RR) along the root axis, unscaled: complex [..., H, H] over
    the broadcast shape of k (real or complex) and r (real).

    The band values h_n(k r) (SR) or j_n(k r) (RR) come from one K5 launch
    in its unscaled mode; one K2 launch (`coax_fold`) with zero exponents
    forms the band sum at the packed child-state entries, which are then
    unpacked.  On CPU tensors both run their plain versions.  Like the JAX
    package, this overflows float32 from n_end ~ k r + 20; the scaled
    `coaxial_scaled` does not.
    """
    from ._scaled import _coax_packed, coax_fold

    _root_axis(c)
    if kind not in ("SR", "RR"):
        raise ValueError(f"kind must be 'SR' or 'RR', got {kind!r}")
    z = k * r
    rdt = z.real.dtype  # k may be complex: the tables and exponents stay real
    tab = _coax_packed(c, n_end, rdt, z.device)
    j, _, h, _ = spherical_jh_all(c.c_ndim, 2 * n_end - 1, z.reshape(1, -1))
    radm = h if kind == "SR" else j
    e0 = torch.zeros((1, n_end), dtype=rdt, device=z.device)
    vals = coax_fold(radm, torch.zeros_like(radm.real), e0, e0, tab)[0]
    dense = unpack(replace(tab.layout, vals=vals))  # [P, H, H]
    return dense.reshape(z.shape + dense.shape[-2:])


def unique_radii(r_np):
    """(uniq, inv): the distinct host radii, rounded to 10 decimals (a
    lattice's repeats merge), and the index of each radius into them.  The
    coaxial factor depends on |t| only: a 4x4 lattice has 24 offsets and 9
    distinct radii."""
    uniq, inv = np.unique(np.round(r_np, 10), return_inverse=True)
    return uniq, inv.reshape(np.shape(r_np))


def _offsets_of(c, n_end, t_sph, t_cart, k):
    """(r, pick, rot) of offsets given as tensors, from one host copy of
    them: the radii at which to build the coaxial factor (the distinct |t|
    when the offsets are one batch axis, repeat, and k's trailing axis
    broadcasts against them, else every |t|), `pick`, which takes a factor
    [..., r, H, H] built there to one per offset, and the cached D of the
    directions."""
    r_t, t_hat = _unit_offsets(c, t_sph, t_cart)
    host = torch.cat([r_t[..., None], t_hat], dim=-1).detach().cpu().double().numpy()
    rot = rotation_d(c, n_end, host[..., 1:], t_hat.dtype, t_hat.device)
    if r_t.ndim == 1 and (k.ndim == 0 or k.shape[-1] == 1):
        uniq, inv = unique_radii(host[:, 0])
        if len(uniq) < len(inv):
            inv = torch.as_tensor(inv, device=r_t.device)
            return (torch.as_tensor(uniq, dtype=r_t.dtype, device=r_t.device),
                    lambda x: x[..., inv, :, :], rot)
    return r_t, lambda x: x, rot


def sr_rotation(c, t_sph, n_end, k, kind="SR", t_cart=None):
    """(S|R) (or (R|R)) by rotation + coaxial: complex [..., H, H].

    t by its spherical mapping (with "r"), or by its cartesian offsets
    t_cart [d, ...], which are then used directly.  k: real tensor
    broadcasting against the offsets' batch shape.
    """
    _root_axis(c)
    r, pick, rot = _offsets_of(c, n_end, t_sph, t_cart, k)
    return _sandwich(pick(coaxial_sr(c, r, n_end, k, kind=kind)), rot)


def _sandwich(coax, rot):
    """D @ coax @ D^H for the RotationD rot, by D's degree groups.

    D is exactly degree-block-diagonal, so X D^H takes one [.., H, g] x
    [g, g] product per column group and D (X D^H) one [g, g] x [g, H]
    product per row group: H sum(g^2) multiply-adds each instead of H^3.
    D comes from its masked degree blocks (`rotation_blocks`).
    """
    groups, blocks = rot.groups, rot.blocks
    batch = torch.broadcast_shapes(coax.shape[:-2], blocks[0].shape[:-2])
    h_num = coax.shape[-1]
    tmp = coax.new_empty(batch + (h_num, h_num))
    for (s, e), dg in zip(groups, blocks):
        tmp[..., s:e] = coax[..., s:e] @ dg.mH
    out = coax.new_empty(batch + (h_num, h_num))
    for (s, e), dg in zip(groups, blocks):
        out[..., s:e, :] = dg @ tmp[..., s:e, :]
    return out
