"""The coaxial band tables U: the port's host index vectors, root tables and
KU's plain version (`ops/coax_u.py::_coax_u_plain`, the CPU path of
`coax_u`) against the JAX package's `_coax_tables` and a frozen copy of the
numpy path the port used before KU.

Tolerances: the root tables are the same quadrature and Jacobi recurrence
in both packages (1e-13).  U is a sum over the rule's nodes, formed in
another order than the reference's: each entry is held within 1e-14 of its
own sum of magnitudes sum_q |tz w t_a t_b| (entries span many orders of
magnitude, so a tolerance of the largest entry would hide the small ones),
and bands above l + l' and slots past a ragged tile must be exactly 0.
"""

import sys

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.translation._rotation import _coax_tables as j_coax_tables
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import _index
from biem_helmholtz_sphere_tpu_torch.harmonics._index import _child_states, _zonal_jobs, basis
from biem_helmholtz_sphere_tpu_torch.ops import coax_u as ku
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import pack_layout
from biem_helmholtz_sphere_tpu_torch.ops.coax_u import _GROUP, _TILE, _coax_u_plain, coax_u
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import program_numpy
from biem_helmholtz_sphere_tpu_torch.translation import _rotation, _scaled
from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
    _coax_index,
    _coax_tables,
    _coax_tables_on,
)
from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
    _TILE_COST,
    _UNIT_SLABS,
    _child_state_blocks,
    _coax_packed,
    _coax_plan_on,
    _coax_tiles,
)

CPU = torch.device("cpu")
TREES = {"ba": 8, "bpa": 6, "bba": 6, "bpbpa": 5, "bbba": 5}


# ---- the frozen reference: the port's numpy path before KU ----------------

def _old_child_states(c, n_end):
    """Child-state ids as the port numbered them with a loop over h."""
    b = basis(c, n_end)
    nids = [n.nid for n in c.nodes if n.nid != c.root.nid]
    keys = {}
    cs = np.empty(b.num, dtype=np.int64)
    for h in range(b.num):
        key = tuple(int(b.node_job_index[i][h]) for i in nids)
        cs[h] = keys.setdefault(key, len(keys))
    return cs


def _old_tiles(u, lsum, n_sm):
    """The K2 tiles, units and image as the port laid them out on the host,
    tile by tile (frozen copy)."""
    top = lsum // _GROUP
    order = np.argsort(-top, kind="stable")
    cuts = np.flatnonzero(np.diff(top[order])) + 1
    runs = [(int(a), int(b), int(top[order[a]])) for a, b in
            zip(np.r_[0, cuts], np.r_[cuts, len(order)])]
    n_tiles = [-(-(b - a) // _TILE) for a, b, _ in runs]
    size = [g + 1 for _, _, g in runs]
    n_units = [-(-n // max(1, _UNIT_SLABS // s)) for n, s in zip(n_tiles, size)]

    def heaviest(r):
        return -(-n_tiles[r] // n_units[r]) * (size[r] + _TILE_COST)

    while sum(n_units) < n_sm:
        r = max((r for r in range(len(runs)) if n_units[r] < n_tiles[r]), key=heaviest,
                default=None)
        if r is None:
            break
        n_units[r] += 1
    units, slab = [], 0
    image = np.zeros((sum(n * s for n, s in zip(n_tiles, size)), 2, _TILE, 4))
    for (a, b, g), n, k in zip(runs, n_tiles, n_units):
        t0 = 0
        for i in range(k):
            t1 = t0 + n // k + (i < n % k)
            e0, e1 = a + t0 * _TILE, min(b, a + t1 * _TILE)
            units.append((e0, e1 - e0, g, slab))
            for s0 in range(e0, e1, _TILE):
                ent = order[s0 : min(s0 + _TILE, e1)]
                blk = u[: (g + 1) * _GROUP, ent].reshape(g + 1, 2, 4, len(ent))
                image[slab : slab + g + 1, :, : len(ent)] = blk.transpose(0, 1, 3, 2)
                slab += g + 1
            t0 = t1
    units = np.asarray(units, dtype=np.int64).reshape(-1, 4)
    most = int(((-(-units[:, 1] // _TILE)) * (units[:, 2] + 1)).max())
    return order, units, image, most


def _old_packed(tree, n_end):
    """(u, image, order, units, most, sum of magnitudes [NG * G, nnz]) from
    the JAX package's tables by the port's former numpy formula."""
    zf, w, tz, t_cols, ell, cs = (np.asarray(a) for a in j_coax_tables(j_tree(tree), n_end, True))
    ell = ell.astype(np.int64)
    lay = pack_layout(np.bincount(cs), np.argsort(cs, kind="stable"), len(ell), CPU)
    rows, cols = lay.rows.numpy(), lay.cols.numpy()
    n_bands = 2 * n_end - 1
    ng = -(-n_bands // _GROUP)
    u = (tz * w[:, None]).T @ (t_cols[:, rows] * t_cols[:, cols])
    mag = np.abs(tz * w[:, None]).T @ np.abs(t_cols[:, rows] * t_cols[:, cols])
    lsum = ell[rows] + ell[cols]
    u = np.where(lsum[None, :] >= np.arange(n_bands)[:, None], u, 0.0)
    pad = np.zeros((ng * _GROUP - n_bands, u.shape[1]))
    u, mag = np.concatenate([u, pad]), np.concatenate([mag, pad])
    order, units, image, most = _old_tiles(u, lsum, 132)
    return u, image, order, units, most, mag


def _mag_image(mag, tab):
    """The sums of magnitudes laid out as the tile image of `tab`."""
    _, _, image, _ = _old_tiles(mag, (tab.l_row + tab.l_col).numpy(), 132)
    return image


# ---- the tests -------------------------------------------------------------

@pytest.mark.parametrize("tree", list(TREES))
def test_root_tables_match_the_jax_package(tree):
    """zf, w, tz, t_cols, ell and cs of the device path (the host index
    vectors and the root tables built on a device, here the CPU) against
    the JAX package's `_coax_tables` within 1e-13; the six-tuple kept for
    the tools reads the same parts."""
    n_end = TREES[tree]
    c = create_from_branching_types(tree)
    zf_j, w_j, tz_j, tc_j, ell_j, cs_j = (np.asarray(a) for a in
                                          j_coax_tables(j_tree(tree), n_end, True))
    zf, _, w, ell, cs = _coax_index(c, n_end)
    t, tzw = _coax_tables_on(c, n_end, CPU)
    assert t.dtype == tzw.dtype == torch.float64 and t.is_contiguous()
    assert t.shape == tc_j.T.shape and tzw.shape == tz_j.shape == (len(w), 2 * n_end - 1)
    for got, ref in ((zf, zf_j), (w, w_j), (t.T.numpy(), tc_j), (tzw.numpy(), tz_j * w_j[:, None]),
                     (_coax_tables(c, n_end)[2], tz_j), (_coax_tables(c, n_end)[3], tc_j)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13 * max(1.0, np.abs(ref).max()))
    np.testing.assert_array_equal(ell, ell_j)
    np.testing.assert_array_equal(cs, cs_j)


@pytest.mark.parametrize("tree", list(TREES))
def test_zonal_jobs_are_the_wide_basis_zonal_jobs(tree):
    """The root's zonal jobs (0, n''), n'' < 2 n_end - 1, by n'', equal the
    jobs with nc = 0 of `basis(c, 2 n_end - 1)`'s root, for every root kind
    the coax path takes ('b' and 'bp')."""
    c = create_from_branching_types(tree)
    n_end = min(TREES[tree], 5)
    jobs2 = basis(c, 2 * n_end - 1).node_jobs[c.root.nid]
    ref = sorted((p for p in jobs2 if p[0] == 0), key=lambda p: p[1])
    assert _zonal_jobs(c, n_end) == ref
    with pytest.raises(ValueError):
        _zonal_jobs(create_from_branching_types("caa"), n_end)


@pytest.mark.parametrize("tree", list(TREES) + ["a", "caa", "bcaa"])
def test_child_states_equal_the_loop_numbering(tree):
    """The vectorised child-state ids equal the former loop's (first
    appearance in h), and the harmonic program's child states are the
    same ids, each with its h ascending by root job."""
    c = create_from_branching_types(tree)
    n_end = min(TREES.get(tree, 5), 6)
    cs = _child_states(c, n_end)
    np.testing.assert_array_equal(cs, _old_child_states(c, n_end))
    perm = program_numpy(c, n_end)["perm"]
    assert np.all(np.diff(cs[perm]) >= 0) and np.array_equal(np.sort(perm), np.arange(len(cs)))


@pytest.mark.parametrize("tree,n_end", [("ba", 5), ("ba", 8), ("bpa", 6), ("bba", 5),
                                        ("bpbpa", 4), ("bbba", 4)])
def test_coax_u_plain_matches_the_former_numpy_path(tree, n_end):
    """`_coax_packed` on the CPU (the plain KU) against the frozen numpy
    path, entry by entry within 1e-14 of each entry's sum of magnitudes in
    float64 (and within float32 rounding of it in float32), with bands
    above l + l' and slots past a ragged tile exactly 0; the plan, order
    and units equal the former ones."""
    c = create_from_branching_types(tree)
    u_r, img_r, order_r, units_r, most_r, mag = _old_packed(tree, n_end)
    for dtype, rel in ((torch.float64, 0.0), (torch.float32, 2.0 ** -24)):
        n0 = coax_u.launches
        tab = _coax_packed(c, n_end, dtype, CPU)
        assert coax_u.launches == n0  # CPU tensors take the plain version
        u, img = tab.u.double().numpy(), tab.u_tiles.double().numpy()
        assert u.shape == u_r.shape and img.shape == img_r.shape
        assert np.all(np.abs(u - u_r) <= 1e-14 * mag + rel * np.abs(u_r))
        assert np.all(np.abs(img - img_r) <= 1e-14 * _mag_image(mag, tab) + rel * np.abs(img_r))
        lsum = (tab.l_row + tab.l_col).numpy()
        assert not np.any(u[np.arange(len(u))[:, None] > lsum[None, :]])
        np.testing.assert_array_equal(tab.order[:, 0].numpy(), order_r)
        np.testing.assert_array_equal(tab.units.numpy(), units_r)
        assert tab.unit_slabs == most_r
        for start, cnt, g, slab in tab.units.tolist():  # past each ragged tile: zeros
            for t0 in range(0, cnt, _TILE):
                s = slab + (t0 // _TILE) * (g + 1)
                assert not np.any(img[s : s + g + 1, :, min(_TILE, cnt - t0):])


def test_coax_u_plain_is_chunk_independent(monkeypatch):
    """The plain version's chunks of entries (bounded by _U_BYTES) give the
    same tables as one chunk, within 1e-14 of the sums of magnitudes."""
    c = create_from_branching_types("bba")
    n_end = 5
    tab = _coax_packed(c, n_end, torch.float64, CPU)
    mag = _old_packed("bba", n_end)[5]
    layout, plan = _coax_plan_on(c, n_end, CPU)[:2]
    tables = _coax_tables_on(c, n_end, CPU)
    monkeypatch.setattr(ku, "_U_BYTES", 8 * 7 * (tables[1].shape[0] + 2 * tables[1].shape[1]))
    u, img = _coax_u_plain(tables, layout, plan, torch.float64)
    assert np.all(np.abs(u.numpy() - tab.u.numpy()) <= 1e-14 * mag)
    assert torch.equal(img == 0, tab.u_tiles == 0)


def test_coax_tables_never_enumerate_the_wide_basis(monkeypatch):
    """Building the coax tables cold calls `basis` at n_end only, never at
    2 n_end - 1 (every module of the port that imported it is spied on)."""
    orig, seen = _index.basis, []

    def spy(c, n_end):
        seen.append(n_end)
        return orig(c, n_end)

    for mod in list(sys.modules.values()):
        if mod is not None and getattr(mod, "__name__", "").startswith(
                "biem_helmholtz_sphere_tpu_torch") and getattr(mod, "basis", None) is orig:
            monkeypatch.setattr(mod, "basis", spy)
    for fn in (_rotation._coax_index, _rotation._coax_tables_on, _rotation._coax_tables,
               _scaled._coax_plan_on, _scaled._coax_packed_on, _scaled._child_state_blocks,
               _child_states):
        fn.cache_clear()
    c = create_from_branching_types("bba")
    tab = _coax_packed(c, 5, torch.float64, CPU)
    _coax_tables(c, 5)
    assert tab.u.shape[0] == 16 and seen and set(seen) == {5}


def _check_plan(lsum, n_sm):
    """The vectorised plan covers every packed entry once: tiles of one top
    group, consecutive in order, of at most _TILE entries, slabs laid out
    tile after tile, and units made of whole consecutive tiles."""
    order, units, tiles, slabs, most = _coax_tiles(lsum, n_sm)
    nnz = len(lsum)
    assert np.array_equal(np.sort(order), np.arange(nnz))
    top = lsum[order] // _GROUP
    assert np.all(np.diff(top) <= 0)
    start, cnt, g, slab = tiles.T
    assert start[0] == 0 and np.array_equal(start[1:], np.cumsum(cnt)[:-1])
    assert start[-1] + cnt[-1] == nnz and np.all((cnt >= 1) & (cnt <= _TILE))
    assert np.all(top[start] == g) and np.all(top[start + cnt - 1] == g)
    assert slab[0] == 0 and np.array_equal(slab[1:], np.cumsum(g + 1)[:-1])
    assert slabs == int((g + 1).sum())
    first = np.searchsorted(start, units[:, 0])
    assert np.array_equal(start[first], units[:, 0]) and np.array_equal(slab[first], units[:, 3])
    assert np.array_equal(units[:, 2], g[first])
    ends = np.r_[first[1:], len(tiles)]
    assert np.array_equal(units[:, 1], [cnt[a:b].sum() for a, b in zip(first, ends)])
    assert most == max(int((g[a:b] + 1).sum()) for a, b in zip(first, ends))
    return order, units, most


@pytest.mark.parametrize("n_end", [2, 8, 40])
def test_vectorised_tile_plan_covers_every_entry_once(n_end):
    """At n_end 2, 8 and 40 ('ba'): the plan covers every packed entry
    once and equals the former tile-by-tile plan."""
    c = create_from_branching_types("ba")
    ell = _coax_index(c, n_end)[3]
    lay = pack_layout(*_child_state_blocks(c, n_end), len(ell), CPU)
    lsum = ell[lay.rows.numpy()] + ell[lay.cols.numpy()]
    order, units, most = _check_plan(lsum, 132)
    ngg = -(-(2 * n_end - 1) // _GROUP) * _GROUP
    order_r, units_r, _, most_r = _old_tiles(np.zeros((ngg, len(lsum))), lsum, 132)
    np.testing.assert_array_equal(order, order_r)
    np.testing.assert_array_equal(units, units_r)
    assert most == most_r


def test_tile_plan_has_no_size_ceiling():
    """3D n_end=128 (1,398,144 packed entries, 255 bands), host side only:
    the index vectors and the plan build, and every unit stays within
    K2's slab budget (a tile's slabs where one tile exceeds it)."""
    c = create_from_branching_types("ba")
    n_end = 128
    zf, th, w, ell, cs = _coax_index(c, n_end)
    assert len(w) == 257 and len(zf) == 2 * n_end - 1 and cs.max() == 2 * n_end - 2
    lay = pack_layout(*_child_state_blocks(c, n_end), len(ell), CPU)
    lsum = ell[lay.rows.numpy()] + ell[lay.cols.numpy()]
    assert len(lsum) == 1398144
    _, units, most = _check_plan(lsum, 132)
    assert most <= max(_UNIT_SLABS, -(-(2 * n_end - 1) // _GROUP))


# ---- KU's plan on the card (csrc/coax_u.cu), on the host ------------------

# KU's cases (tree, n_end): chip_smoke.py phase 2's (i) 4D first block, (ii)
# the bench, (iii) 'ba' at 64 and (v) 96, past any size ceiling
_KU_PLAN_CASES = {"bba-20": ("bba", 20), "ba-32": ("ba", 32), "ba-64": ("ba", 64),
                  "ba-96": ("ba", 96)}


@pytest.mark.parametrize("case", list(_KU_PLAN_CASES))
def test_ku_plan_covers_every_band_of_every_tile_once(case):
    """KU's tiles cover every packed entry once (`_check_plan`), and its
    warps (`ku._ku_work`) cover each tile's 64 rows x band groups 0 .. g
    exactly once, in one pass up to 16 groups (n_end <= 64) and in passes of
    16 past that; its shared memory is the same at every n_end and leaves
    an H100's SM room for two CTAs."""
    tree, n_end = _KU_PLAN_CASES[case]
    c = create_from_branching_types(tree)
    ell = _coax_index(c, n_end)[3]
    lay = pack_layout(*_child_state_blocks(c, n_end), len(ell), CPU)
    lsum = ell[lay.rows.numpy()] + ell[lay.cols.numpy()]
    _check_plan(lsum, 132)
    tiles = _coax_tiles(lsum, 132)[2]
    for g in np.unique(tiles[:, 2]):
        work = ku._ku_work(int(g))
        hits = np.zeros((_TILE, g + 1), np.int64)
        for _, w, m0, grp in work:
            assert m0 == 16 * (w % 4) and grp % 2 == (w // 4) % 2
            hits[m0:m0 + 16, grp] += 1
        assert (hits == 1).all()
        assert max(p for p, _, _, _ in work) + 1 == -(-(g + 1) // ku._KU_GROUPS_PASS)
        per = np.bincount([p * 8 + w for p, w, _, _ in work])
        assert per.max() <= ku._KU_GROUPS_W
    assert (g + 1 <= ku._KU_GROUPS_PASS) == (n_end <= 64)
    assert ku._ku_smem() == 105216 and 2 * (ku._ku_smem() + 1024) <= 228 * 1024


def _ku_emulate(tables, layout, plan, dtype, direct):
    """csrc/coax_u.cu's two passes on the host in float64: per tile P =
    t_a t_b over its 64 rows (zero past a ragged end), per (pass, warp, m
    tile, group) of `_ku_work` the product of its 16 rows with the group's 8
    bands, written from the MMA fragments' lanes (row g or g + 8, bands
    2 t and 2 t + 1) to the image, masked to l + l' >= n; then each
    entry's column of u read back from the image, tile by tile where
    `direct` (each CTA its own tile's), else through the map `where` (pass
    2)."""
    t, tzw = (x.numpy() for x in tables)
    q, nb = tzw.shape
    nnz = layout.rows.shape[0]
    order, tiles = plan.order.numpy(), plan.tiles.numpy()
    rows, cols = layout.rows.numpy(), layout.cols.numpy()
    z = np.zeros((q, plan.ng * _GROUP))
    z[:, :nb] = tzw
    u = np.zeros((plan.ng * _GROUP, nnz))
    img = np.full((plan.slabs, 2, _TILE, 4), np.nan)
    for first, n, g, slab in tiles:
        e = order[first:first + n, 0]
        ls = np.full(_TILE, -1)
        ls[:n] = (order[first:first + n, 1] & 0xFFFF) + (order[first:first + n, 1] >> 16)
        p = np.zeros((_TILE, q))
        p[:n] = t[rows[e]] * t[cols[e]]
        for _, _, m0, grp in ku._ku_work(int(g)):
            d = p[m0:m0 + 16] @ z[:, grp * _GROUP:(grp + 1) * _GROUP]  # [16, 8]
            for lane in range(32):
                gl, tq = lane >> 2, lane & 3
                for h in range(2):
                    j, n0 = m0 + gl + 8 * h, grp * _GROUP + 2 * tq
                    v = [d[gl + 8 * h, 2 * tq + c] if n0 + c <= ls[j] else 0.0 for c in (0, 1)]
                    img[slab + grp, tq >> 1, j, 2 * (tq & 1):2 * (tq & 1) + 2] = v
        if direct:  # the tile's own columns of u from its slabs (0 above: u starts at 0)
            u[:(g + 1) * _GROUP, e] = img[slab:slab + g + 1, :, :n, :].transpose(
                0, 1, 3, 2).reshape(-1, n)
    if direct:
        return torch.as_tensor(u).to(dtype), torch.as_tensor(img).to(dtype)
    where = np.empty(nnz, np.int64)  # pass 1's map: tile << 6 | row of each entry
    for ti, (first, n, _, _) in enumerate(tiles):
        where[order[first:first + n, 0]] = ti << 6 | np.arange(n)
    for e in range(nnz):  # pass 2: each entry's column of u from the image, 0 above
        first, n, g, slab = tiles[where[e] >> 6]
        u[:(g + 1) * _GROUP, e] = img[slab:slab + g + 1, :, where[e] & 63, :].reshape(-1)
    return torch.as_tensor(u).to(dtype), torch.as_tensor(img).to(dtype)


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "two-pass"])
@pytest.mark.parametrize("tree,n_end,groups_w", [("ba", 8, 8), ("bba", 5, 8), ("ba", 9, 1)])
def test_ku_emulation_matches_the_plain_version(tree, n_end, groups_w, direct, monkeypatch):
    """The host emulation of KU's tiles, warps, fragment lanes and second
    pass (`_ku_emulate`) fills u and the image as the plain version does: each
    entry within 1e-14 of its sum of magnitudes, exactly 0 wherever that
    sum is, every image slot written; with one group a warp (two a pass)
    the passes take a 'ba' n_end=9 tile's three groups; u written by pass
    1 itself (direct) or by pass 2 from the image."""
    monkeypatch.setattr(ku, "_KU_GROUPS_W", groups_w)
    monkeypatch.setattr(ku, "_KU_GROUPS_PASS", 2 * groups_w)
    c = create_from_branching_types(tree)
    layout, plan = _coax_plan_on(c, n_end, CPU)[:2]
    tables = _coax_tables_on(c, n_end, CPU)
    got = _ku_emulate(tables, layout, plan, torch.float64, direct)
    ref = _coax_u_plain(tables, layout, plan, torch.float64)
    mag = _coax_u_plain(tuple(x.abs() for x in tables), layout, plan, torch.float64)
    for gt, r, m in zip(got, ref, mag):
        assert bool(torch.isfinite(gt).all())
        assert bool(((gt - r).abs() <= 1e-14 * m).all())
        assert bool((gt[m == 0] == 0).all())


def test_ku_writes_u_itself_only_where_its_tiles_are_one_wave():
    """KU's first pass writes u itself where its tiles are one wave of a
    CTA an SM on a 132-SM H100 (the 5D pair's 32 tiles); the bench's 346,
    the 4D first block's 463 and 'ba' n_end=64's 2,740 take the second
    pass."""
    for tree, n_end, n_tiles, direct in (("bbba", 8, 32, True), ("ba", 32, 346, False),
                                         ("bba", 20, 463, False), ("ba", 64, 2740, False)):
        plan = _coax_plan_on(create_from_branching_types(tree), n_end, CPU)[1]
        assert plan.tiles.shape[0] == n_tiles
        assert ku._ku_direct(n_tiles, 132) == direct
