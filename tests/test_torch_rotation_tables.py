"""K3's tables and its plan on the CPU: `_rot_tables_on` (the rotation's
quadrature tables built in plain torch float64 on a device, here the CPU)
against the JAX package's host tables; K3's plan (`_k3_plan`, `_k3_jobs`,
`_k3_slab`: each degree block's rows cut into CTA shares, its columns of
every direction side by side in strips, the nodes in slabs of harmonics);
and a numpy walk of K3 as its kernels run it (slab by slab: every harmonic
at every direction's rotated nodes by the program's child states, once;
then CTA by CTA and chunk by chunk, a share's rows of conj(Y) w times its
strip's harmonics summed in two levels, added to the earlier slabs', both
forms written at the last) against `rotation_blocks` per degree block and
the JAX package's rotation_matrix."""

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
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import program_numpy
from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
    _K3_KQ,
    _K3_LINE,
    _K3_LINES,
    _K3_RMAX,
    _K3_SCRATCH,
    _degree_groups,
    _k3_jobs,
    _k3_layout,
    _k3_plan,
    _k3_ratios,
    _k3_slab,
    _root_axis,
    _rot_tables,
    _rot_tables_on,
    _rot_ycw,
    _rotation_to_axis,
    rotation_blocks,
)

from test_torch_harmonic_program import factor_product, jacobi_step, job_seed, tree_angles

TREES = [("ba", 8), ("bpa", 5), ("bba", 5), ("bcaa", 4)]


def _dirs(d, n=5, seed=11):
    t = np.random.default_rng(seed).normal(size=(n, d))
    t[0] = 0.0
    t[0, -1] = -1.0  # opposite the root axis of a 'b' root
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def program_harmonics(t, ang):
    """Every harmonic at the points of `ang` (x, c, s by node id, each
    [points]) as the kernel's generation walks the program: per child
    state the subtree's factors, then the root's recurrence through its
    degrees, entry woff + j at flat harmonic perm[woff + j]: [H, points]."""
    x0, c0, s0 = (a[0] for a in ang)
    y = np.zeros((len(t["perm"]), x0.shape[-1]), dtype=complex)
    kind = t["nodes"][-1][0]  # the root comes last (children first)
    for cs, (job0, n_j, woff, _) in enumerate(t["cs"]):
        sub = factor_product(t, t["csjob"][cs], 1, ang)
        job = t["jobs"][job0]
        pn, pm = job_seed(t, kind, job, c0, s0), 0.0
        for j in range(n_j):
            y[t["perm"][woff + j]] = sub * pn
            if j + 1 < n_j:
                pn, pm = jacobi_step(t, t["fam"][job[0]] + j, x0, pn, pm)
    return y


def k3_walk(c, t_hat, n_end, double, slab=None):
    """K3 in numpy float64 as its kernels run it: (groups' blocks [N, G, G]
    each, packed [N, nnz], the times each (direction, harmonic) was
    generated at each node, the times each entry of both forms was written
    in full)."""
    t = program_numpy(c, n_end)
    plan = _k3_plan(c, n_end, double)
    info64 = plan.info.view(np.int64)
    n_dir = len(t_hat)
    desc = _k3_jobs(c, n_end, double, n_dir)
    ycw = _rot_ycw(c, n_end, torch.complex128, "cpu")[0].numpy()  # [chunks, hp, line]
    ycwt = ycw[:, :, :_K3_KQ].transpose(1, 0, 2).reshape(ycw.shape[1], -1)  # [hp, q_pad]
    s_cart = _rot_tables_on(c, n_end, "cpu")[2].numpy()
    q_num, q_pad = s_cart.shape[1], ycwt.shape[1]
    h_num = len(t["perm"])
    if slab is None:
        slab = _k3_slab(n_dir, h_num, q_pad, double)
    rot = _rotation_to_axis(torch.as_tensor(t_hat), _root_axis(c), c.c_ndim).numpy()
    grp = np.zeros(n_dir * plan.g_all, dtype=complex)
    packed = np.zeros((n_dir, plan.nnz), dtype=complex)
    wrote = [np.zeros(grp.shape, dtype=int), np.zeros(packed.shape, dtype=int)]
    gens = np.zeros((n_dir, h_num, q_pad), dtype=int)
    for q0 in range(0, q_pad, slab):
        qn = min(slab, q_pad - q0)
        q = np.minimum(np.arange(q0, q0 + qn), q_num - 1)  # padding nodes repeat the last
        harm = np.stack([program_harmonics(t, tree_angles(t, rot[n].T @ s_cart[:, q]))
                         for n in range(n_dir)])  # [N, H, qn], each entry once
        gens[:, t["perm"], q0 : q0 + qn] += 1
        for blk, c0, r0, nr in desc:
            o, g, big_g, oi, op, w = plan.info[blk, :6]
            g_pre, v_off = info64[blk, 3:5]
            wu = min(w, n_dir * g - c0)
            cc = c0 + np.arange(wu)
            n8 = -(-nr // 8) * 8
            part = np.zeros((n8, wu), dtype=complex)
            acc = np.zeros((n8, wu), dtype=complex)
            n_chunks = qn // _K3_KQ
            for ci in range(n_chunks):
                k = slice(ci * _K3_KQ, (ci + 1) * _K3_KQ)
                b = harm[cc // g, o + cc % g, k]  # the strip's lines [wu, 32]
                a = ycwt[op + r0 : op + r0 + n8, q0 + ci * _K3_KQ : q0 + (ci + 1) * _K3_KQ]
                part += a @ b.T
                if ci % 2 == 1 or ci == n_chunks - 1:  # two levels, 64 nodes apart
                    acc += part
                    part[:] = 0
            i = np.arange(nr)[:, None]
            n, j = (cc // g)[None, :], (cc % g)[None, :]
            gi = g_pre * n_dir + n * big_g * big_g + (oi + r0 + i) * big_g + oi + j
            grp[gi] = acc[:nr] if q0 == 0 else grp[gi] + acc[:nr]
            if q0 + qn >= q_pad:  # the last slab: both forms
                pi = v_off + (r0 + i) * g + j
                packed[np.broadcast_to(n, pi.shape), pi] = grp[gi]
                np.add.at(wrote[0], gi, 1)
                np.add.at(wrote[1], (np.broadcast_to(n, pi.shape), pi), 1)
    blocks, pos = [], 0
    for s, e in _degree_groups(c, n_end):
        size = (e - s) ** 2 * n_dir
        blocks.append(grp[pos : pos + size].reshape(n_dir, e - s, e - s))
        pos += size
    return blocks, packed, gens, wrote


def _block_entries(c, n_end, n_dir):
    """The exact degree-block entries of the degree groups' flat buffer
    (N g_all), as a mask."""
    n_root = basis(c, n_end).n_root
    out = []
    for s, e in _degree_groups(c, n_end):
        nr = n_root[s:e]
        out.append(np.broadcast_to(nr[:, None] == nr[None, :], (n_dir, e - s, e - s)).ravel())
    return np.concatenate(out)


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("btype,n_end", TREES)
def test_k3_walk_equals_rotation_blocks(btype, n_end, double):
    """K3 as its kernels run it (the complex64 plan in one slab of nodes,
    the complex128 plan in slabs of 64) equal to `rotation_blocks` (the
    plain version on the CPU) per degree group within 1e-12, the zeros
    between a group's degree blocks exact, the packed form the groups'
    degree blocks, each entry of both forms written once and each harmonic
    of each direction generated once at each node."""
    c = create_from_branching_types(btype)
    t_hat = _dirs(c.c_ndim)
    blocks, packed, gens, wrote = k3_walk(c, t_hat, n_end, double, 64 if double else None)
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
    np.testing.assert_array_equal(wrote[0], _block_entries(c, n_end, len(t_hat)).astype(int))
    assert (wrote[1] == 1).all() and (gens == 1).all()


@pytest.mark.parametrize("btype,n_end", TREES)
def test_rot_tables_on_a_device_equal_the_host_tables(btype, n_end):
    """`_rot_tables_on` (plain torch float64, here on the CPU) equal to the
    JAX package's host tables within 1e-13 (weights, conj(Y), points,
    root degrees); `_rot_tables`, the plain version's, is its numpy, and
    K3's conj(Y) w is their product, chunk-major in lines of 32 nodes and
    padding, each degree block's rows at its `_k3_layout` offset, zero on
    the padding rows, nodes and line ends."""
    c = create_from_branching_types(btype)
    w, yc, s_cart, n_root = (tonp(a) for a in j_rot_tables(j_tree(btype), n_end, True))
    w_t, yc_t, s_t, n_t = _rot_tables_on(c, n_end, "cpu")
    np.testing.assert_allclose(w_t.numpy(), w, rtol=1e-13, atol=0)
    np.testing.assert_allclose(yc_t.numpy(), yc, rtol=0, atol=1e-13)
    np.testing.assert_allclose(s_t.numpy(), s_cart, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(n_t.numpy(), n_root)
    for got, ref in zip(_rot_tables(c, n_end), (w_t, yc_t, s_t, n_t)):
        np.testing.assert_array_equal(got, ref.numpy())
    ycw3, _ = _rot_ycw(c, n_end, torch.complex64, "cpu")
    src, op = _k3_layout(c, n_end)
    q_num = len(w)
    assert ycw3.shape == (-(-q_num // 32), len(src), _K3_LINE[False]) and len(src) % 8 == 0
    assert not ycw3[:, :, 32:].any()
    ycw = ycw3[:, :, :32].transpose(0, 1).reshape(len(src), -1)
    ref = (yc_t * w_t[:, None]).to(torch.complex64).T
    assert torch.equal(ycw[src >= 0, :q_num], ref[src[src >= 0]])
    assert not ycw[src < 0].any() and not ycw[:, q_num:].any()
    assert (op % 8 == 0).all() and (src[op] == np.cumsum([0] + [
        harm_n_ndim(n, c.c_ndim) for n in range(n_end - 1)])).all()


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("btype,n_end,n_dir", [("ba", 20, 37), ("bba", 12, 40),
                                               ("bcaa", 6, 5), ("bba", 24, 3)])
def test_k3_plan_tiles_every_degree_block_once(btype, n_end, n_dir, double):
    """K3's CTAs cover each exact degree-block entry of each direction
    exactly once (their shares' rows times their strips' columns), a share
    at most 64 rows, a multiple of 8 but the last; a block's group and row
    in it follow `_degree_groups`, its packed offset `pack_layout`, its
    first row `_k3_layout`."""
    c = create_from_branching_types(btype)
    plan = _k3_plan(c, n_end, double)
    info, info64 = plan.info, plan.info.view(np.int64)
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    groups = _degree_groups(c, n_end)
    assert plan.g_all == sum((e - s) ** 2 for s, e in groups)
    assert plan.nnz == sum(g * g for g in sizes)
    lay = pack_layout(sizes, None, sum(sizes), "cpu")
    np.testing.assert_array_equal(info64[:, 4], lay.voffs.numpy())
    np.testing.assert_array_equal(info[:, 4], _k3_layout(c, n_end)[1])
    for n, (o, g, big_g, oi) in enumerate(info[:, :4]):
        s, e = next((s, e) for s, e in groups if s <= o < e)
        assert (g, big_g, oi) == (sizes[n], e - s, o - s) and oi + g <= big_g
        assert info64[n, 3] == sum((b - a) ** 2 for a, b in groups if b <= s)
    seen = [np.zeros((n_dir, g, g), dtype=int) for g in sizes]
    for blk, c0, r0, nr in _k3_jobs(c, n_end, double, n_dir):
        assert 0 < nr <= _K3_RMAX and r0 % 8 == 0 and (nr % 8 == 0 or r0 + nr == sizes[blk])
        g, w = sizes[blk], info[blk, 5]
        cc = np.arange(c0, min(c0 + w, n_dir * g))
        np.add.at(seen[blk], (cc // g, slice(r0, r0 + nr), cc % g), 1)
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("btype,n_end", [("ba", 128), ("bba", 32), ("bcaa", 20)])
def test_k3_node_tables_do_not_grow_with_n_end(btype, n_end):
    """K3 keeps no node table: each generation thread carries one
    recurrence at a time (a child state's subtree, then its root degrees),
    so no per-CTA state grows with n_end; a CTA's lines (its strip's
    columns and its share's rows, at most 64) fit one ring stage at any
    n_end, and a slab of the harmonics at the rotated nodes stays within
    `_K3_SCRATCH` bytes wherever 64 nodes of them do."""
    c = create_from_branching_types(btype)
    t = program_numpy(c, n_end)
    h_num = len(t["perm"])
    for double in (False, True):
        plan = _k3_plan(c, n_end, double)
        rows = [max(nr for _, nr in shares) for shares in plan.shares]
        assert max(rows) <= _K3_RMAX
        assert all(w + -(-r // 8) * 8 <= _K3_LINES[double] and w >= 16
                   for w, r in zip(plan.info[:, 5], rows))
        line = _K3_LINE[double] * (16 if double else 8)  # bytes of 32 nodes' line
        for n_dir in (1, 64, 4096):
            slab = _k3_slab(n_dir, h_num, 1 << 20, double)
            assert slab % 64 == 0 and (slab == 64 or n_dir * h_num * slab // 32 * line
                                       <= _K3_SCRATCH)
        assert _k3_slab(1, h_num, 96, double) == 96


@pytest.mark.parametrize("btype,n_end", [("ba", 6), ("bba", 4)])
def test_k3_walk_matches_jax_rotation_matrix(btype, n_end):
    """K3 as its kernels run it against the JAX package's rotation_matrix,
    1e-12."""
    c_t = create_from_branching_types(btype)
    t_hat = _dirs(c_t.c_ndim, n=3, seed=5)
    blocks, _, _, _ = k3_walk(c_t, t_hat, n_end, True, 64)
    ref = tonp(j_rotation_matrix(j_tree(btype), t_hat, n_end))
    for (s, e), got in zip(_degree_groups(c_t, n_end), blocks):
        np.testing.assert_allclose(got, ref[:, s:e, s:e], rtol=0, atol=1e-12)


@pytest.mark.parametrize("double", [False, True])
@pytest.mark.parametrize("btype,n_end,n_dir", [("ba", 19, 1984), ("ba", 32, 36),
                                               ("bba", 20, 64)])
def test_k3_plan_pads_the_product_little(btype, n_end, n_dir, double):
    """Product entries K3 computes (a share's rows to a multiple of 8, a
    strip's columns to the consumers' step) over those needed (N sum g^2)
    at most 1.35 at the lattice's half table, the bench's slots and the 4D
    hypercube's slots (64 x 64 tiles per block: 8.5x, 3.0x, 1.31x)."""
    pad, _ = _k3_ratios(create_from_branching_types(btype), n_end, double, n_dir)
    assert 1.0 <= pad <= 1.35


@pytest.mark.parametrize("btype,n_end,n_dir", [("bba", 20, 64), ("ba", 32, 36), ("ba", 64, 40),
                                               ("bba", 24, 40)])
def test_k3_generates_each_harmonic_once_per_direction(btype, n_end, n_dir):
    """Harmonic generations per direction over H: 1.0 at every size (the
    64 x 64 tiles: 4.46x at 'bba' n_end=20), also past 512 rows ('bba'
    n_end=24, g = 576): the pre-pass writes each harmonic of each direction
    once at each node (the program's child states list every harmonic
    once) and every CTA share of a strip reads them."""
    c = create_from_branching_types(btype)
    perm = program_numpy(c, n_end)["perm"]
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(perm)))
    for double in (False, True):
        assert _k3_ratios(c, n_end, double, n_dir)[1] == 1.0
        shares = _k3_plan(c, n_end, double).shares
        if n_end == 24:
            assert max(len(s) for s in shares) > 8  # more shares than a cluster holds
