"""The plane-wave right-hand side (KR, ops/plane_rhs.py) and the matrix-free
operators' per-geometry tables, on the CPU.

KR's plain version, which `plane_wave_rhs` runs on CPU tensors, is held to
the JAX package's `_rhs_plane_wave` on the same numpy inputs: every tree
kind ('a', 'ba', 'bpa', 'caa', 'bba'), real and complex k, one geometry and
one per k, one direction and one per k, the u_in term, the gradient term
and both.  The JAX values are committed in tests/golden/
test_torch_plane_rhs.npz (`jax_golden`; its spherical-function compiles
take minutes on the CPU).  Tolerance per (k, sphere, degree) block,
relative to the block's largest entry (j_n falls by orders of magnitude
from degree to degree, so a tolerance relative to the largest entry would
pass a spoiled high degree): 1e-12 in complex128, 1e-5 in complex64
against the complex128 JAX value.

The kernel itself runs only on the card (tests/test_torch_cuda.py); here a
numpy model of it (`_kr_model`) reads the arguments the wrapper prepares
(`_kr_inputs`: the strides and the grid), the tree's program (`ke_perm`,
`n_root`, `hjob`) and the kept table of Y (read and written as the kernel
does, by the stamps), and is held to the plain version cold, warm and
after a change of direction; the grid's coverage and the wrapper's launch
packs are checked on the host.

The per-geometry tables: from the second call on one geometry neither
`_pair_routing` nor `make_route` runs (both operators), a moved center
gets a routing equal to a fresh one, and a warm two-block sweep gives the
cold one's density bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_golden
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.biem._core import _check_biem_inputs as j_check_inputs
from biem_helmholtz_sphere_tpu.biem._core import _rhs_plane_wave as j_rhs_plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types, from_cartesian
from biem_helmholtz_sphere_tpu_torch.harmonics._eval import harmonics
from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import harmonic_program, program_numpy
from biem_helmholtz_sphere_tpu_torch.special._family import spherical_jh_all
from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_const

TREES = {"a": 8, "ba": 8, "bpa": 8, "caa": 6, "bba": 6}
N_K, N_B = 2, 3
KS = {"real": np.array([1.3, 2.1]), "complex": np.array([1.3 + 0.2j, 2.1 + 0.05j])}
FLAGS = {"uin": (True, False), "grad": (False, True), "both": (True, True)}
TOL = {torch.complex128: 1e-12, torch.complex64: 1e-5}
CASES = list(itertools.product(TREES, KS, ("one", "per-k"), ("one", "per-k")))


def _inputs(tree, kname, geom, dirn):
    """(k [K], direction [d, K], centers [K, B, d], radii, alpha, beta [K, B])
    of one case, numpy, from its own seed."""
    d = create_from_branching_types(tree).c_ndim
    seed = CASES.index((tree, kname, geom, dirn))
    rng = np.random.default_rng(100 + seed)
    centers = rng.normal(size=(N_K if geom == "per-k" else 1, N_B, d)) * 3.0
    direction = rng.normal(size=(d, N_K if dirn == "per-k" else 1))
    direction = direction / np.linalg.norm(direction, axis=0)
    radii = rng.uniform(0.5, 1.0, size=(N_K, N_B))
    alpha, beta = (rng.normal(size=(N_K, N_B)) + 1j * rng.normal(size=(N_K, N_B))
                   for _ in range(2))
    return (KS[kname], np.broadcast_to(direction, (d, N_K)).copy(),
            np.broadcast_to(centers, (N_K, N_B, d)).copy(), radii, alpha, beta)


def _key(case, flags):
    return "-".join(case) + "-" + flags


def jax_golden():
    """The JAX package's `_rhs_plane_wave` at every case and term choice."""
    out = {}
    for case in CASES:
        tree = case[0]
        k, direction, centers, radii, alpha, beta = _inputs(*case)
        c = j_tree(tree)
        kj = C(np.asarray(k.real), np.asarray(k.imag)) if np.iscomplexobj(k) else k
        uin, _ = j_plane_wave(k=kj, direction=direction)
        _, kw, dirw = uin._analytic
        cen, rad, _, _, al, be = j_check_inputs(c, centers, radii, np.asarray(k.real), None,
                                                alpha, beta)
        for flags, (has_uin, has_grad) in FLAGS.items():
            out[_key(case, flags)] = tonp(j_rhs_plane_wave(
                c, TREES[tree], cen, rad, al, be, kw, jnp.asarray(dirw), has_uin, has_grad))
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_plane_rhs")


def _torch_inputs(tree, kname, geom, dirn, cdt):
    """The case's inputs as torch tensors in `cdt`'s types, shaped as
    `_core._rhs_plane_wave` takes them (centers [B, d] for one geometry)."""
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    k, direction, centers, radii, alpha, beta = _inputs(tree, kname, geom, dirn)
    kw = torch.tensor(k, dtype=cdt if np.iscomplexobj(k) else rdt)
    cen = torch.tensor(centers[0] if geom == "one" else centers, dtype=rdt)
    return (kw, torch.tensor(direction, dtype=rdt), cen, torch.tensor(radii, dtype=rdt),
            torch.tensor(alpha, dtype=cdt), torch.tensor(beta, dtype=cdt))


def degree_rel_err(got, ref, n_root):
    """The largest error of a (k, sphere, degree) block over that block's
    largest |ref|; got, ref [K, B, H]."""
    worst = 0.0
    for n in np.unique(n_root):
        m = n_root == n
        err = np.abs(got[..., m] - ref[..., m]).max(-1)
        top = np.abs(ref[..., m]).max(-1)
        worst = max(worst, float((err / np.maximum(top, 1e-300)).max()))
    return worst


@pytest.mark.parametrize("cdt", [torch.complex128, torch.complex64], ids=["c128", "c64"])
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_plane_wave_rhs_matches_jax(jax_values, case, flags, cdt):
    """`_core._rhs_plane_wave` on CPU tensors (K5's plain version, then
    `plane_wave_rhs`, which runs KR's plain version and launches nothing)
    against the JAX package, per (k, sphere, degree) block."""
    tree = case[0]
    c = create_from_branching_types(tree)
    kw, direction, centers, radii, alpha, beta = _torch_inputs(*case, cdt)
    has_uin, has_grad = FLAGS[flags]
    n0 = plane_rhs.plane_wave_rhs.launches
    got = _core._rhs_plane_wave(c, TREES[tree], centers, radii, alpha, beta, kw, direction,
                                has_uin, has_grad)
    assert plane_rhs.plane_wave_rhs.launches == n0
    ref = jax_values[_key(case, flags)]
    assert got.shape == ref.shape == (N_K, N_B, basis(c, TREES[tree]).num)
    assert got.dtype == cdt
    n_root = basis(c, TREES[tree]).n_root
    assert degree_rel_err(got.numpy().astype(np.complex128), ref, n_root) <= TOL[cdt]


# --- a numpy model of the kernel ---------------------------------------------


def _kr_harmonics(c, n_end, v):
    """Y_h(v) [H] for cartesian v [d] (float64) as csrc/harmonics.cuh
    evaluates them from the program: the angles node by node from v
    (tree_angles), then each harmonic's node factors at its jobs `hjob`
    from their seeds (factor_product)."""
    t = program_numpy(c, n_end)
    n = t["n_nodes"]
    r, ax, ac, sn_, kind = ([0.0] * n for _ in range(5))
    for kd, nid, a0, a1 in t["nodes"]:
        kind[nid] = kd
        r1 = v[a0] if kd == 0 else r[a0]
        r2 = r[a1] if kd == 2 else v[a1]
        rr = float(np.hypot(r1, r2))
        first, second = (r2, r1) if kd == 1 else (r1, r2)
        cs, sn = (first / rr, second / rr) if rr > 0 else (1.0, 0.0)
        r[nid], ac[nid], sn_[nid] = rr, cs, sn
        ax[nid] = (cs - sn) * (cs + sn) if kd == 2 else cs
    out = np.ones(t["h_num"], np.complex128)
    for h in range(t["h_num"]):
        for nid in range(n):
            f, steps, p1, p2 = t["jobs"][t["hjob"][h, nid]]
            if kind[nid] == 0:
                out[h] *= (ac[nid] + 1j * np.sign(p1) * sn_[nid]) ** abs(p1) / np.sqrt(2 * np.pi)
                continue
            pref = (sn_[nid] ** p1 if kind[nid] == 1
                    else t["famr"][f, 1] * ac[nid] ** p1 * sn_[nid] ** p2)
            pn, pm = pref * t["famr"][f, 0], 0.0
            for j in range(steps):
                c1, c2, c3 = t["coef"][t["fam"][f] + j, :3]
                pn, pm = (ax[nid] * c1 + c2) * pn - c3 * pm, pn
            out[h] *= pn
    return out


def _storage(t):
    """The elements a kernel reads of t by its strides, from its first
    (numpy, 1-D)."""
    n = 1 + sum((size - 1) * step for size, step in zip(t.shape, t.stride()))
    return torch.as_strided(t, (n,), (1,)).numpy()


def _kr_plan(h_num, n_rows, rows_per, ranges):
    """The kernel's work as csrc/plane_rhs.cu splits it: per CTA (unit,
    range) its walk entries and the rows each copy of its owners takes,
    over `n_rows` rows (k, b) in all: yields (unit, range, entries [n],
    rows of each copy [copies])."""
    for unit in range(-(-h_num // plane_rhs._UNIT)):
        u0 = unit * plane_rhs._UNIT
        n_own = min(plane_rhs._THREADS, -(-(h_num - u0) // plane_rhs._PER))
        own = -(-n_own // 32) * 32
        copies = plane_rhs._THREADS // own
        ent = np.arange(u0, min(h_num, u0 + n_own * plane_rhs._PER))
        for rg in range(ranges):
            r0, r1 = rg * rows_per, min(n_rows, (rg + 1) * rows_per)
            yield unit, rg, ent, [range(r0 + cp, r1, copies) for cp in range(copies)]


def _kr_model(c, n_end, out_shape, args):
    """What csrc/plane_rhs.cu writes for the launch arguments `args` (as
    `_kr_inputs` makes them) and its kept table (`args`' tab, read and
    updated in place): its grid of (unit of walk entries, range of rows),
    each CTA's slice of cy read where its stamp holds the bits of the first
    k's direction, else formed (at every walk entry of the unit) and
    written with its stamp, and formed again in the range at a k whose
    direction's bits differ from the previous k's; the rows' phase from the
    same roundings, in float64.  Returns (out, entries formed)."""
    (j, jp, kw, skv, kc, dirt, sdd, sdk, cen, sck, scb, scd, alpha, sak, sab, beta, sbk, sbb,
     pg, tab, h_num, d, has_uin, has_grad, rows_per, neg_a) = args
    n_k, n_balls, ne = j.shape
    rows = n_k * n_balls
    j, jp, kv, dv, cv, av, bv = map(_storage, (j, jp, kw, dirt, cen, alpha, beta))
    perm, n_walk = pg.ke_hn.numpy().T
    n_root = np.empty_like(n_walk)
    n_root[perm] = n_walk
    assert (n_root == basis(c, n_end).n_root).all()
    assert (pg.hjob.numpy() == program_numpy(c, n_end)["hjob"]).all()
    cy_tab, stamp = tab.cy.numpy(), tab.stamp.numpy()
    units, rows_per_g, ranges = plane_rhs._grid(h_num, rows, tab.r_cap)
    assert rows_per_g == rows_per and stamp.shape[1] == units and ranges <= tab.r_cap
    out = np.full(out_shape, np.nan, np.complex128)
    evals = 0

    def dir_of(k):
        return np.array([dv[i * sdd + k * sdk] for i in range(d)])

    def form(k, ent):
        y = _kr_harmonics(c, n_end, dir_of(k))[perm[ent]]
        return np.conj(y) * (1j ** n_root[perm[ent]]) * neg_a

    for unit, rg, ent, copy_rows in _kr_plan(h_num, rows, rows_per, ranges):
        k_first = (rg * rows_per) // n_balls
        st = stamp[rg, unit]
        if st[d] == 1 and (st[:d] == dir_of(k_first)).all():  # equal bits (no NaN here)
            cy0 = cy_tab[rg, ent]
        else:
            cy0 = form(k_first, ent)
            evals += len(ent)
            cy_tab[rg, ent] = cy0
            stamp[rg, unit, :d], stamp[rg, unit, d] = dir_of(k_first), 1
        for rws in copy_rows:
            cy, k_prev = cy0, k_first
            for row in rws:
                k, b = divmod(row, n_balls)
                for kk in range(k_prev + 1, k + 1):
                    if (dir_of(kk) != dir_of(kk - 1)).any():
                        cy = form(kk, ent)
                        evals += len(ent)
                k_prev = k
                kk = complex(kv[k * skv]) if kc else float(kv[k * skv])
                ip = sum(dv[i * sdd + k * sdk] * cv[k * sck + b * scb + i * scd]
                         for i in range(d))
                phase = np.exp(1j * kk * ip)
                r = (k * n_balls + b) * ne + n_root[perm[ent]]
                term = 0.0
                if has_uin:
                    term = term + av[k * sak + b * sab] * j[r]
                if has_grad:
                    term = term + bv[k * sbk + b * sbb] * (jp[r] * kk)
                assert np.isnan(out[k, b, perm[ent]]).all(), "one writer per output"
                out[k, b, perm[ent]] = phase * term * cy
    return out, evals


def _model_inputs(tree, n_end, n_k, n_b, per_k_dir, seed=7):
    """KR's arguments (float64, complex k, both terms) at n_k k and n_b
    spheres: a shared geometry, alpha broadcast, one direction or one per
    k."""
    c = create_from_branching_types(tree)
    d = c.c_ndim
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64)
    kw = torch.tensor(rng.uniform(0.5, 2.0, n_k) + 0.1j * rng.uniform(size=n_k))
    direction = torch.tensor(rng.normal(size=(d, n_k if per_k_dir else 1)), **f64)
    direction = (direction / direction.norm(dim=0)).expand(d, n_k)
    centers = torch.tensor(rng.normal(size=(n_b, d)) * 3, **f64)
    radii = torch.tensor(rng.uniform(0.5, 1, size=(n_k, n_b)), **f64)
    alpha = torch.tensor(rng.normal(size=(1, n_b)) + 0j)
    beta = torch.tensor(rng.normal(size=(n_k, n_b)) + 1j * rng.normal(size=(n_k, n_b)))
    j, jp, _, _ = spherical_jh_all(d, n_end, kw[:, None] * radii)
    return c, n_end, j.contiguous(), jp.contiguous(), kw, direction, centers, alpha, beta, True, \
        True


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("tree", ["a", "ba", "caa", "bba", "bbba", "cbaba"])
def test_kernel_model_matches_the_plain_version(tree, split, monkeypatch):
    """The numpy model of the kernel, on the arguments the wrapper passes
    (strides of a shared geometry, a repeated direction and broadcast
    alpha) and its kept table, equals KR's plain version within 1e-12 per
    degree block: cold (every slice formed once), warm (no slice formed,
    the same bits) and after a change of direction (every slice formed
    again), the rows in one range (whole) or one a range (split)."""
    monkeypatch.setattr(plane_rhs, "_FILL_CTAS", 10 ** 6 if split else 1)
    n_end = 5 if tree in ("bbba", "cbaba") else 6
    n_k, n_b = 3, 4
    args = list(_model_inputs(tree, n_end, n_k, n_b, False))
    c = args[0]
    plane_rhs.kr_table.cache_clear()
    h_num = basis(c, n_end).num
    ranges = n_k * n_b if split else 1
    outs = []
    for call in ("cold", "warm", "turned"):
        if call == "turned":
            args[5] = args[5] * 0.8 + torch.roll(args[5], 1, dims=0) * 0.6
            args[5] = args[5] / args[5].norm(dim=0, keepdim=True)
        ref = plane_rhs.plane_wave_rhs_plain(*args)
        out_shape, kargs = plane_rhs._kr_inputs(*args)
        assert kargs[24] == (1 if split else n_k * n_b)
        got, evals = _kr_model(c, n_end, out_shape, kargs)
        assert evals == (0 if call == "warm" else h_num * ranges)
        assert degree_rel_err(got, ref.numpy(), basis(c, n_end).n_root) <= 1e-12
        outs.append(got)
    assert np.array_equal(outs[0], outs[1])


# the grid's cases (tree, n_end, K, B): the bench, phase 9 (b)'s 4,096
# circles, the bench at one k, and a ragged count of spheres
_GRID_CASES = {"bench": ("ba", 32, 4, 16), "circles-4096": ("a", 32, 1, 4096),
               "k-1": ("ba", 32, 1, 16), "ragged": ("bba", 11, 3, 37)}


@pytest.mark.parametrize("case", list(_GRID_CASES))
def test_grid_covers_every_output_once(case):
    """`_grid` and the kernel's split of a CTA's work (`_kr_plan`) write
    every (k, sphere, harmonic) exactly once; at the bench 64 x 1,024
    outputs take at least 132 CTAs (the old grid's 32 slices of 32
    harmonics took 32)."""
    tree, n_end, n_k, n_b = _GRID_CASES[case]
    c = create_from_branching_types(tree)
    h_num = basis(c, n_end).num
    rows = n_k * n_b
    r_cap = plane_rhs._r_cap(h_num, 8)
    units, rows_per, ranges = plane_rhs._grid(h_num, rows, r_cap)
    assert ranges <= r_cap and (ranges - 1) * rows_per < rows <= ranges * rows_per
    perm = harmonic_program(c, n_end, torch.float64, torch.device("cpu")).ke_perm.numpy()
    hits = np.zeros((rows, h_num), np.int64)
    ctas = 0
    for _, _, ent, copy_rows in _kr_plan(h_num, rows, rows_per, ranges):
        ctas += 1
        for rws in copy_rows:
            hits[np.asarray(list(rws), dtype=np.int64)[:, None], perm[ent][None, :]] += 1
    assert (hits == 1).all()
    assert ctas == units * ranges
    if case == "bench":
        assert ctas >= 132


@pytest.mark.parametrize("per_k_dir", [False, True], ids=["one-direction", "per-k"])
def test_model_forms_each_slice_once_a_direction(per_k_dir, monkeypatch):
    """At 12 k x 3 spheres in 9 ranges of 4 rows (ranges cut inside a k;
    H = 25, so each CTA's 13 owners have 4 copies, a row each): one
    direction forms each CTA's slice once cold and never warm; directions
    per k form each range's slice at its first k cold (warm: from the
    stamp) and, in each copy, again at every later k it reaches; the warm
    call gives the cold one's bits."""
    monkeypatch.setattr(plane_rhs, "_FILL_CTAS", 9)
    args = _model_inputs("ba", 5, 12, 3, per_k_dir, seed=11)
    c = args[0]
    plane_rhs.kr_table.cache_clear()
    h_num = basis(c, 5).num
    out_shape, kargs = plane_rhs._kr_inputs(*args)
    assert kargs[24] == 4
    cold, ev_cold = _kr_model(c, 5, out_shape, kargs)
    warm, ev_warm = _kr_model(c, 5, out_shape, kargs)
    assert np.array_equal(cold, warm)
    later = 0  # (copy, later k) pairs: a k past its range's first, in a copy's rows
    for _, rg, _, copy_rows in _kr_plan(h_num, 36, 4, 9):
        later += sum(max(r // 3 for r in rws) - (rg * 4) // 3 for rws in copy_rows if len(rws))
    if per_k_dir:
        assert ev_cold == h_num * (9 + later) and ev_warm == h_num * later
    else:
        assert ev_cold == h_num * 9 and ev_warm == 0
    ref = plane_rhs.plane_wave_rhs_plain(*args)
    assert degree_rel_err(cold, ref.numpy(), basis(c, 5).n_root) <= 1e-12


def test_launch_pack_is_kept_per_layout(monkeypatch):
    """The wrapper's launch pack (`_launch_pack`: `_kr_inputs`' checks, the
    fixed arguments in the kernel's slots with the program's and the kept
    table's addresses) is made once
    per layout of the arguments: equal shapes and strides reuse it (other
    tensors, the same pack), a changed stride (centers per k in place of a
    shared geometry) makes a new one, and a changed dtype another."""
    calls = []
    inputs = plane_rhs._kr_inputs

    def spy(*a, **kw):
        calls.append(1)
        return inputs(*a, **kw)

    monkeypatch.setattr(plane_rhs, "_kr_inputs", spy)
    plane_rhs._packs.clear()
    args = list(_model_inputs("ba", 6, 3, 4, False))
    first = plane_rhs._launch_pack(*args)
    args[6] = args[6] + 1.0  # new centers, the same layout
    assert plane_rhs._launch_pack(*args) is first and len(calls) == 1
    shape, slots, tab, pg = first
    slot = dict(zip(plane_rhs._SLOTS, slots.tolist()))
    assert shape == (3, 4, 36) and slots.dtype == np.int64
    assert tab is plane_rhs.kr_table(args[0], 6, torch.complex128, torch.device("cpu"), None)
    assert slot["hn"] == pg.ke_hn.data_ptr() and slot["cy"] == tab.cy.data_ptr()
    assert (slot["K"], slot["B"], slot["H"], slot["ne"], slot["d"], slot["dbl"]) == (
        3, 4, 36, 6, 3, 1)
    assert slots[plane_rhs._SLOTS.index("neg_a")].view(np.float64) == -_a_const(3)
    assert (slot["sck"], slot["scb"], slot["scd"], slot["sak"], slot["sab"]) == (0, 3, 1, 0, 1)
    args[6] = args[6][None].expand(3, -1, -1).contiguous()  # strides change
    moved = plane_rhs._launch_pack(*args)
    assert moved is not first and len(calls) == 2
    assert plane_rhs._launch_pack(*args) is moved and len(calls) == 2
    args[3] = args[3].to(torch.complex64)  # j's dtype: another layout (and a refused one)
    with pytest.raises(ValueError):
        plane_rhs._launch_pack(*args)
    assert len(calls) == 3


def test_launch_pack_and_table_are_kept_per_stream():
    """A launch pack and its kept table belong to one stream (the stream
    handle is in both keys): the same stream reuses them, another stream
    gets its own table, so two streams never share a slice."""
    plane_rhs._packs.clear()
    plane_rhs.kr_table.cache_clear()
    args = _model_inputs("ba", 6, 3, 4, False)
    first = plane_rhs._launch_pack(*args, stream=0x10)
    assert plane_rhs._launch_pack(*args, stream=0x10) is first
    other = plane_rhs._launch_pack(*args, stream=0x20)
    assert other is not first and other[2] is not first[2]
    assert other[2].cy.data_ptr() != first[2].cy.data_ptr()
    assert plane_rhs._launch_pack(*args) is not first  # the CPU's (no stream)


def test_program_tables_of_the_kernel():
    """The program's device tables KR reads: hjob is program_numpy's, ke_hn
    each walk entry's (h, n_h) with h a permutation (KE's order) and n_h
    basis's root degree, wcs each entry's child state, all int32, and the
    model's harmonics are the plain ones at a direction on an axis (where
    'b' angles are 0 or pi)."""
    for tree in ("a", "ba", "bpa", "caa", "bba", "bcaa"):
        c = create_from_branching_types(tree)
        pg = harmonic_program(c, 5, torch.float64, torch.device("cpu"))
        assert pg.hjob.dtype == pg.ke_hn.dtype == pg.wcs.dtype == torch.int32
        assert (pg.hjob.numpy() == program_numpy(c, 5)["hjob"]).all()
        h, n_h = pg.ke_hn.numpy().T
        assert np.array_equal(np.sort(h), np.arange(basis(c, 5).num))
        assert (n_h == basis(c, 5).n_root[h]).all() and (h == pg.ke_perm.numpy()).all()
        woff, n_j = pg.walk.numpy()[:, 2], pg.walk.numpy()[:, 1]
        assert (np.repeat(np.arange(pg.n_cs), n_j) == pg.wcs.numpy()).all()
        assert (woff[pg.wcs.numpy()] <= np.arange(len(h))).all()
        for axis in range(c.c_ndim):
            v = np.zeros(c.c_ndim)
            v[axis] = -1.0 if axis % 2 else 1.0
            ref = harmonics(c, from_cartesian(c, torch.tensor(v)), 5).numpy()
            assert np.abs(_kr_harmonics(c, 5, v) - ref).max() <= 1e-12


# --- the per-geometry tables ---------------------------------------------------


def _clear_geometry_caches():
    for fn in (_core._routing_of, _core._route_of, _core._factored_geometry,
               _core._offsets_of, _core._degree_tables):
        fn.cache_clear()


def _lattice(shift=0.0):
    """Four unit spheres on a 2 x 2 lattice at pitch 3.5 (the last moved
    up by shift)."""
    g = np.array([-1.75, 1.75])
    xx, yy = np.meshgrid(g, g)
    centers = np.stack([xx.ravel(), yy.ravel(), np.zeros(4)], axis=1)
    centers[3, 2] += shift
    return centers


def _sweep(stable, centers_np, blocks=2):
    """A sweep of `blocks` k-blocks of 2 k on the 4 spheres ('ba', n_end
    4, plane wave along x0) through the matrix-free route, warm-started:
    the factored operator (stable) or the offset table; its densities."""
    c = create_from_branching_types("ba")
    f = dict(dtype=torch.float32 if stable else torch.float64)
    centers = torch.tensor(centers_np, **f)
    dens, out = None, []
    for b in range(blocks):
        k = torch.tensor([1.1 + 0.2 * b, 1.2 + 0.2 * b], **f)
        uin, _ = plane_wave(k=k, direction=torch.tensor([[1.0] * 2, [0.0] * 2, [0.0] * 2], **f))
        calc = biem(c, centers=centers.expand(2, -1, -1), radii=torch.ones(2, 4, **f), k=k,
                    n_end=4, uin=uin, solver="matfree", stable=stable, density0=dens)
        dens = calc.density[-1]
        out.append(calc.density)
    return out


@pytest.mark.parametrize("stable", [True, False], ids=["factored", "offset-table"])
def test_second_block_builds_no_routing(stable, monkeypatch):
    """From the second k-block on one geometry neither `_pair_routing` nor
    `make_route` runs, on the factored and on the offset-table operator,
    and the cached tables are the same objects."""
    _clear_geometry_caches()
    calls = {"_pair_routing": 0, "make_route": 0}
    for name in calls:
        fn = getattr(_core, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(_core, name, counted)
    centers_np = _lattice()
    _sweep(stable, centers_np, blocks=1)
    assert calls == {"_pair_routing": 1, "make_route": 1}
    first = _core._routing_of(*_core._geometry_key(centers_np), stable)
    _sweep(stable, centers_np, blocks=2)
    assert calls == {"_pair_routing": 1, "make_route": 1}
    assert _core._routing_of(*_core._geometry_key(centers_np), stable) is first


@pytest.mark.parametrize("radius_slots", [True, False])
def test_moved_center_gets_a_fresh_routing(radius_slots):
    """A geometry with one center moved hits no cached entry: its routing
    and KC tables equal, array by array, those built afresh."""
    _core._routing_of(*_core._geometry_key(_lattice()), radius_slots)
    moved = _lattice(shift=0.5)
    key = _core._geometry_key(moved)
    got = _core._routing_of(*key, radius_slots)
    ref = _core._pair_routing(moved, radius_slots)
    for field in ("uniq", "lane", "src", "dst", "dn", "slot_ptr", "uniq_r"):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    assert (got.p_max, got.g_max) == (ref.p_max, ref.g_max)
    assert got is not _core._routing_of(*_core._geometry_key(_lattice()), radius_slots)
    route, lane = _core._route_of(*key, radius_slots, torch.device("cpu"), 0, len(got.uniq))
    ref_route = _core.make_route(ref.src, ref.dst, ref.dn, len(moved), "cpu")
    for field in ("src", "dst", "dn", "csr_ptr", "csr_lane", "csr_dn", "src_ptr", "src_lane"):
        assert torch.equal(getattr(route, field), getattr(ref_route, field)), field
    assert torch.equal(lane, torch.as_tensor(ref.lane))


@pytest.mark.parametrize("stable", [True, False], ids=["factored", "offset-table"])
def test_warm_sweep_equals_the_cold_one(stable):
    """The densities of a two-block warm-started sweep with the geometry's
    tables cached equal, bit for bit, those of the same sweep from cold
    caches."""
    centers_np = _lattice()
    _clear_geometry_caches()
    cold = _sweep(stable, centers_np)
    warm = _sweep(stable, centers_np)
    for a, b in zip(cold, warm):
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


def test_plane_wave_rhs_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card is refused, not moved."""
    c = create_from_branching_types("ba")
    j = torch.zeros((1, 1, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        plane_rhs.plane_wave_rhs(c, 3, j, j, torch.ones(1, device="meta"),
                                 torch.ones(3, 1, device="meta"), torch.ones(1, 3, device="meta"),
                                 j[..., 0], j[..., 0], True, False)


def test_launch_pack_slots_are_the_kernels():
    """`_SLOTS` names the slots of a launch pack in the order of
    csrc/plane_rhs.cu's `enum Slot` (the kernel reads the pack by it)."""
    import re
    from pathlib import Path

    src = (Path(plane_rhs.__file__).parent.parent / "csrc" / "plane_rhs.cu").read_text()
    names = re.search(r"enum Slot \{([^}]*)\}", src).group(1).replace("\n", " ").split(",")
    names = [n.strip() for n in names if n.strip()]
    assert names[-1] == "kSlots" and len(names) - 1 == len(plane_rhs._SLOTS)
    for c_name, py_name in zip(names, plane_rhs._SLOTS):
        assert c_name[1:].lower() == py_name.replace("_", "").lower(), (c_name, py_name)
