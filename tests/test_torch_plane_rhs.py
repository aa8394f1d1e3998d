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
(`_kr_inputs`: the strides and the grid) and the tree's program
(`hjob`, `n_root`), and is held to the plain version.

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


def _kr_model(c, n_end, out_shape, args):
    """What csrc/plane_rhs.cu writes for the launch arguments `args` (as
    `_kr_inputs` makes them): its grid of (slice of 32 harmonics, range of
    spheres, range of k), Y of the slice evaluated at a range's first k and
    again only where the direction's bits change, the rows' phase from the
    same roundings, in float64."""
    (j, jp, kw, skv, kc, dirt, sdd, sdk, cen, sck, scb, scd, alpha, sak, sab, beta, sbk, sbb,
     pg, h_num, d, has_uin, has_grad, b_per, k_per, neg_a) = args
    n_k, n_balls, ne = j.shape
    j, jp, kv, dv, cv, av, bv = map(_storage, (j, jp, kw, dirt, cen, alpha, beta))
    n_root, hjob = pg.n_root.numpy(), pg.hjob.numpy()
    assert (hjob == program_numpy(c, n_end)["hjob"]).all()
    out = np.full(out_shape, np.nan, np.complex128)
    evals = 0
    for s0, b0, k0 in itertools.product(range(0, h_num, 32), range(0, n_balls, b_per),
                                        range(0, n_k, k_per)):
        hs = np.arange(s0, min(s0 + 32, h_num))
        for k in range(k0, min(k0 + k_per, n_k)):
            v = np.array([dv[i * sdd + k * sdk] for i in range(d)])
            if k == k0 or (v != prev).any():
                y = _kr_harmonics(c, n_end, v)[hs]
                evals += len(hs)
                cy = np.conj(y) * (1j ** n_root[hs]) * neg_a
            prev = v
            kk = complex(kv[k * skv]) if kc else float(kv[k * skv])
            for b in range(b0, min(b0 + b_per, n_balls)):
                ip = sum(dv[i * sdd + k * sdk] * cv[k * sck + b * scb + i * scd]
                         for i in range(d))
                phase = np.exp(1j * kk * ip)
                r = (k * n_balls + b) * ne + n_root[hs]
                term = 0.0
                if has_uin:
                    term = term + av[k * sak + b * sab] * j[r]
                if has_grad:
                    term = term + bv[k * sbk + b * sbb] * (jp[r] * kk)
                out[k, b, hs] = phase * term * cy
    return out, evals


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("tree", ["a", "ba", "caa", "bba", "bbba", "cbaba"])
def test_kernel_model_matches_the_plain_version(tree, split, monkeypatch):
    """The numpy model of the kernel, on the arguments the wrapper passes
    (strides of a shared geometry, a repeated direction and broadcast
    alpha), equals KR's plain version within 1e-12 per degree block; the
    model evaluates each harmonic's Y once per repeated direction, and
    once per range where the grid splits the spheres and the k."""
    if split:
        monkeypatch.setattr(plane_rhs, "_MIN_BALLS", 1)
        monkeypatch.setattr(plane_rhs, "_MIN_K", 1)
    c = create_from_branching_types(tree)
    n_end = 5 if tree in ("bbba", "cbaba") else 6
    d = c.c_ndim
    rng = np.random.default_rng(7)
    n_k, n_b = 3, 4
    f64 = dict(dtype=torch.float64)
    kw = torch.tensor([1.1 + 0.1j, 1.7 + 0.0j, 0.6 + 0.3j], dtype=torch.complex128)
    direction = torch.tensor(rng.normal(size=(d, 1)), **f64)
    direction = (direction / direction.norm()).expand(d, n_k)
    centers = torch.tensor(rng.normal(size=(n_b, d)) * 3, **f64)
    radii = torch.tensor(rng.uniform(0.5, 1, size=(n_k, n_b)), **f64)
    alpha = torch.tensor(rng.normal(size=(1, n_b)) + 0j)
    beta = torch.tensor(rng.normal(size=(n_k, n_b)) + 1j * rng.normal(size=(n_k, n_b)))
    j, jp, _, _ = spherical_jh_all(d, n_end, kw[:, None] * radii)
    j, jp = j.contiguous(), jp.contiguous()
    ref = plane_rhs.plane_wave_rhs_plain(c, n_end, j, jp, kw, direction, centers, alpha, beta,
                                         True, True)
    out_shape, args = plane_rhs._kr_inputs(c, n_end, j, jp, kw, direction, centers, alpha, beta,
                                           True, True)
    got, evals = _kr_model(c, n_end, out_shape, args)
    h_num = basis(c, n_end).num
    b_per, k_per = args[-3], args[-2]
    assert evals == h_num * -(-n_b // b_per) * -(-n_k // k_per)
    assert (b_per, k_per) == ((1, 1) if split else (n_b, n_k))
    assert degree_rel_err(got, ref.numpy(), basis(c, n_end).n_root) <= 1e-12


def test_program_tables_of_the_kernel():
    """The program's device tables KR reads: hjob is program_numpy's and
    n_root basis's, as int32, and the model's harmonics are the plain
    ones at a direction on an axis (where 'b' angles are 0 or pi)."""
    for tree in ("a", "ba", "bpa", "caa", "bba", "bcaa"):
        c = create_from_branching_types(tree)
        pg = harmonic_program(c, 5, torch.float64, torch.device("cpu"))
        assert pg.hjob.dtype == pg.n_root.dtype == torch.int32
        assert (pg.hjob.numpy() == program_numpy(c, 5)["hjob"]).all()
        assert (pg.n_root.numpy() == basis(c, 5).n_root).all()
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
