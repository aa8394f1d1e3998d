"""K3's tables and tile loop on the CPU: `_rot_tables_on` (the rotation's
quadrature tables built in plain torch float64 on a device, here the CPU)
against the JAX package's host tables, K3's plan (`_k3_plan`: each degree
block's place in the degree groups and in the packed form, its 64 x 64
tiles, each column tile's node tables of only the rows its columns read),
and a numpy walk of K3's tile loop (each tile's rows of conj(Y) w, its node
tables at the rotated nodes filled work item by work item, the harmonics
as products of table rows, both forms written) against `rotation_blocks`
per degree block and the JAX package's rotation_matrix."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._rotation import _rot_tables as j_rot_tables
from biem_helmholtz_sphere_tpu.translation._rotation import (
    rotation_matrix as j_rotation_matrix,
)
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis, harm_n_ndim
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import pack_layout
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import KIND_A, KIND_B, program_numpy
from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
    _degree_groups,
    _k3_plan,
    _root_axis,
    _rot_tables,
    _rot_tables_on,
    _rot_ycw,
    _rotation_to_axis,
    rotation_blocks,
)

from test_torch_harmonic_program import tree_angles

TREES = [("ba", 8), ("bpa", 5), ("bba", 5), ("bcaa", 4)]


def _dirs(d, n=5, seed=11):
    t = np.random.default_rng(seed).normal(size=(n, d))
    t[0] = 0.0
    t[0, -1] = -1.0  # opposite the root axis of a 'b' root
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def fill_tables(t, plan, ct, ang, q_num):
    """Column tile ct's node tables at the points of `ang`, work item by
    work item, as `fill_item` fills them: [rows, Q]."""
    tab = np.zeros((plan.rows, q_num))
    w0, nw = plan.ctile[ct, :2]
    for nid, row, lo, hi, kind, f, p1, p2 in plan.work[w0 : w0 + nw]:
        x, cc, ss = (a[nid] for a in ang)
        if kind == KIND_A:  # m, -m for |m| = lo..hi by powers of e^{i phi}
            cnt, p = hi - lo + 1, 1.0 / np.sqrt(2.0 * np.pi) + 0j
            for m in range(hi + 1):
                if m >= lo:
                    r = row + 2 * (m - lo)
                    tab[r], tab[r + 1] = p.real, p.imag
                    tab[r + 2 * cnt], tab[r + 2 * cnt + 1] = p.real, -p.imag
                p = p * (cc + 1j * ss)
            continue
        p0, norm = t["famr"][f]
        pref = ss**p1 if kind == KIND_B else norm * cc**p1 * ss**p2
        pn, pm = pref * p0, 0.0
        if lo == 0:
            tab[row] = pn
        for j in range(1, hi + 1):
            c1, c2, c3, _ = t["coef"][t["fam"][f] + j - 1]
            pn, pm = (x * c1 + c2) * pn - c3 * pm, pn
            if j >= lo:
                tab[row + j - lo] = pn
    return tab


def k3_walk(c, t_hat, n_end):
    """K3's tile loop in numpy float64: (groups' blocks [N, G, G] each, packed
    [N, nnz]), written entry by entry as the kernel writes them."""
    t = program_numpy(c, n_end)
    plan = _k3_plan(c, n_end)
    info64 = plan.info.view(np.int64)
    w, yc, s_cart, _ = (a.numpy() for a in _rot_tables_on(c, n_end, "cpu"))
    ycw = yc * w[:, None]
    n_dir, q_num = len(t_hat), s_cart.shape[1]
    rot = _rotation_to_axis(torch.as_tensor(t_hat), _root_axis(c), c.c_ndim).numpy()
    grp = np.zeros(n_dir * plan.g_all, dtype=complex)
    packed = np.zeros((n_dir, plan.nnz), dtype=complex)
    for n in range(n_dir):
        ang = tree_angles(t, rot[n].T @ s_cart)  # the nodes rotated by R_n^T
        for blk, i0, j0, ct in plan.tiles:
            o, g, big_g, oi = plan.info[blk, :4]
            g_pre, v_off = info64[blk, 2:]
            rows = np.arange(i0, min(i0 + 64, g))
            cols = np.arange(j0, min(j0 + 64, g))
            tab = fill_tables(t, plan, ct, ang, q_num)
            y = np.ones((q_num, len(cols)), dtype=complex)  # the tile's harmonics
            for j in range(len(cols)):
                for v in plan.ccol[ct, j]:
                    r = v & ((1 << 30) - 1)
                    y[:, j] *= tab[r] + 1j * tab[r + 1] if v >> 30 else tab[r]
            tile = ycw[:, o + rows].T @ y
            base = g_pre * n_dir + n * big_g * big_g
            grp[base + (oi + rows)[:, None] * big_g + oi + cols] = tile
            packed[n, v_off + rows[:, None] * g + cols] = tile
    blocks, pos = [], 0
    for s, e in _degree_groups(c, n_end):
        size = (e - s) ** 2 * n_dir
        blocks.append(grp[pos : pos + size].reshape(n_dir, e - s, e - s))
        pos += size
    return blocks, packed


@pytest.mark.parametrize("btype,n_end", TREES)
def test_k3_walk_equals_rotation_blocks(btype, n_end):
    """K3's tile loop equal to `rotation_blocks` (the plain version on the
    CPU) per degree group within 1e-12, the zeros between a group's degree
    blocks exact, and the packed form the groups' degree blocks."""
    c = create_from_branching_types(btype)
    t_hat = _dirs(c.c_ndim)
    blocks, packed = k3_walk(c, t_hat, n_end)
    groups, ref = rotation_blocks(c, torch.as_tensor(t_hat), n_end)
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    voffs = pack_layout(sizes, None, int(offs[-1]), "cpu").voffs.numpy()
    for (s, e), got, r in zip(groups, blocks, ref):
        np.testing.assert_allclose(got, r.numpy(), rtol=0, atol=1e-12)
        nr = basis(c, n_end).n_root[s:e]
        assert (got[:, nr[:, None] != nr[None, :]] == 0).all()
        for n in np.nonzero((offs[:-1] >= s) & (offs[:-1] < e))[0]:
            o, g = offs[n] - s, sizes[n]
            np.testing.assert_array_equal(
                packed[:, voffs[n] : voffs[n] + g * g].reshape(-1, g, g),
                got[:, o : o + g, o : o + g])


@pytest.mark.parametrize("btype,n_end", TREES)
def test_rot_tables_on_a_device_equal_the_host_tables(btype, n_end):
    """`_rot_tables_on` (plain torch float64, here on the CPU) equal to the
    JAX package's host tables within 1e-13 (weights, conj(Y), points,
    root degrees); `_rot_tables`, the plain version's, is its numpy, and
    K3's conj(Y) w is their product."""
    c = create_from_branching_types(btype)
    w, yc, s_cart, n_root = (tonp(a) for a in j_rot_tables(j_tree(btype), n_end, True))
    w_t, yc_t, s_t, n_t = _rot_tables_on(c, n_end, "cpu")
    np.testing.assert_allclose(w_t.numpy(), w, rtol=1e-13, atol=0)
    np.testing.assert_allclose(yc_t.numpy(), yc, rtol=0, atol=1e-13)
    np.testing.assert_allclose(s_t.numpy(), s_cart, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(n_t.numpy(), n_root)
    for got, ref in zip(_rot_tables(c, n_end), (w_t, yc_t, s_t, n_t)):
        np.testing.assert_array_equal(got, ref.numpy())
    ycw, _ = _rot_ycw(c, n_end, torch.complex64, "cpu")
    assert torch.equal(ycw, (yc_t * w_t[:, None]).to(torch.complex64))


@pytest.mark.parametrize("btype,n_end", [("ba", 20), ("bba", 12), ("bcaa", 6)])
def test_k3_plan_tiles_every_degree_block_once(btype, n_end):
    """Each (block, row, column) lies in exactly one tile; a block's group
    and row in it follow `_degree_groups`; the packed offsets are
    `pack_layout`'s."""
    c = create_from_branching_types(btype)
    plan = _k3_plan(c, n_end)
    info, info64 = plan.info, plan.info.view(np.int64)
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    groups = _degree_groups(c, n_end)
    assert plan.g_all == sum((e - s) ** 2 for s, e in groups)
    assert plan.nnz == sum(g * g for g in sizes)
    lay = pack_layout(sizes, None, sum(sizes), "cpu")
    np.testing.assert_array_equal(info64[:, 3], lay.voffs.numpy())
    seen = [np.zeros((g, g), dtype=int) for g in sizes]
    for blk, i0, j0, _ in plan.tiles:
        seen[blk][i0 : i0 + 64, j0 : j0 + 64] += 1
    assert all((s == 1).all() for s in seen)
    for n, (o, g, big_g, oi) in enumerate(info[:, :4]):
        s, e = next((s, e) for s, e in groups if s <= o < e)
        assert (g, big_g, oi) == (sizes[n], e - s, o - s) and oi + g <= big_g
        assert info64[n, 2] == sum((b - a) ** 2 for a, b in groups if b <= s)


@pytest.mark.parametrize("btype,n_end", [("ba", 128), ("bba", 32), ("bcaa", 20)])
def test_k3_node_tables_do_not_grow_with_n_end(btype, n_end):
    """A column tile's node tables hold only the rows its columns read: the
    items' rows do not overlap, each (column, node) reads a row of an item
    of that node ('a' flagged by bit 30), every item is read, and a tile's
    rows stay under 200 (the kernel's shared memory) where the tree's jobs
    number in the thousands."""
    c = create_from_branching_types(btype)
    t = program_numpy(c, n_end)
    plan = _k3_plan(c, n_end)
    kinds = {nid: kind for kind, nid, _, _ in t["nodes"]}
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    assert plan.rows <= 200 < len(t["jobs"])
    for blk, _, j0, ct in {tuple(r) for r in plan.tiles[:, [0, 2, 2, 3]]}:
        n_cols = min(64, sizes[blk] - j0)
        w0, nw = plan.ctile[ct, :2]
        items = plan.work[w0 : w0 + nw]
        owner, read = np.full(plan.rows, -1), np.zeros(plan.rows, dtype=bool)
        for nid, row, lo, hi, kind, *_ in items:
            sz = 4 * (hi - lo + 1) if kind == KIND_A else hi - lo + 1
            assert (owner[row : row + sz] == -1).all()
            owner[row : row + sz] = nid
        assert (plan.ccol[ct, n_cols:] == 0).all()
        for nid in range(t["n_nodes"]):
            v = plan.ccol[ct, :n_cols, nid]
            r, is_a = v & ((1 << 30) - 1), v >> 30
            assert (is_a == (kinds[nid] == KIND_A)).all() and (owner[r] == nid).all()
            read[r] = True
            read[r[is_a == 1] + 1] = True
        for nid, row, lo, hi, kind, *_ in items:
            assert read[row : row + (4 * (hi - lo + 1) if kind == KIND_A else hi - lo + 1)].any()


@pytest.mark.parametrize("btype,n_end", [("ba", 6), ("bba", 4)])
def test_k3_walk_matches_jax_rotation_matrix(btype, n_end):
    """K3's tile loop against the JAX package's rotation_matrix, 1e-12."""
    c_t = create_from_branching_types(btype)
    t_hat = _dirs(c_t.c_ndim, n=3, seed=5)
    blocks, _ = k3_walk(c_t, t_hat, n_end)
    ref = tonp(j_rotation_matrix(j_tree(btype), t_hat, n_end))
    for (s, e), got in zip(_degree_groups(c_t, n_end), blocks):
        np.testing.assert_allclose(got, ref[:, s:e, s:e], rtol=0, atol=1e-12)
