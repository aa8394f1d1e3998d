"""The harmonic program (ops/harmonic_program.py) that KE and K3 read, on
the CPU: a numpy walk of its tables doing KE's loop (per child state the
root's recurrence with the radial factor and the density folded in, then
the subtree's factors from their seeds, as csrc/harmonics.cuh does) equal
to `harmonic_sum` within 1e-12 of the largest |u| in complex128, and the
program's factors against the JAX package's harmonics and biem_u.

The walk vectorises over points; its loops over child states, root steps
and nodes are the kernel's.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.biem._eval import biem_u as j_biem_u
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.harmonics import harmonics as j_harmonics
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch.biem._eval import biem_u, harmonic_sum
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types, from_cartesian
from biem_helmholtz_sphere_tpu_torch.harmonics import basis, harmonics
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import tree_radius
from biem_helmholtz_sphere_tpu_torch.special._family import _h_clamped, spherical_h_scaled
from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import (
    KIND_A,
    KIND_B,
    KIND_C,
    harmonic_program,
    ke_runs,
    ke_walk_numpy,
    program_numpy,
    shape_code,
)
from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coax_tables

TREES = [("a", 8), ("bpa", 8), ("bba", 6), ("bpbpa", 5), ("caa", 7), ("bcaa", 4)]


def tree_angles(t, v):
    """(x, c, s) per node id at cartesian points v [d, ...], as the kernel's
    tree_angles: x the recurrence's argument (cos th for 'b', cos 2 th for
    'c', cos phi for 'a'), c and s the angle's cosine and sine."""
    n = t["n_nodes"]
    x, c, s, r = ([None] * n for _ in range(4))
    for kind, nid, a0, a1 in t["nodes"]:
        r1 = v[a0] if kind == KIND_A else r[a0]
        r2 = r[a1] if kind == KIND_C else v[a1]
        rr = np.hypot(r1, r2)
        safe = np.where(rr > 0, rr, 1.0)
        first, second = (r2, r1) if kind == KIND_B else (r1, r2)
        c[nid] = np.where(rr > 0, first / safe, 1.0)
        s[nid] = np.where(rr > 0, second / safe, 0.0)
        r[nid] = rr
        x[nid] = (c[nid] - s[nid]) * (c[nid] + s[nid]) if kind == KIND_C else c[nid]
    return x, c, s


def job_seed(t, kind, job, c, s):
    f, _, p1, p2 = job
    pref = s**p1 if kind == KIND_B else t["famr"][f, 1] * c**p1 * s**p2
    return pref * t["famr"][f, 0]


def jacobi_step(t, row, x, pn, pm):
    c1, c2, c3, _ = t["coef"][row]
    return (x * c1 + c2) * pn - c3 * pm, pn


def a_factor(m, c, s):
    """e^{i m phi} / sqrt(2 pi) as the |m|-th power of e^{i phi}."""
    z = c + 1j * (s if m >= 0 else -s)
    p = 1.0 / np.sqrt(2.0 * np.pi) + 0j
    for _ in range(abs(m)):
        p = p * z
    return p


def node_factor(t, kind, job, x, c, s):
    if kind == KIND_A:
        return a_factor(job[2], c, s)
    pn, pm = job_seed(t, kind, job, c, s), 0.0
    for j in range(job[1]):
        pn, pm = jacobi_step(t, t["fam"][job[0]] + j, x, pn, pm)
    return pn + 0j


def factor_product(t, job_of, first, ang):
    """The product of the factors of nodes first.. at the jobs job_of[nid]."""
    kinds = {nid: kind for kind, nid, _, _ in t["nodes"]}
    y = 1.0 + 0j
    for nid in range(first, t["n_nodes"]):
        y = y * node_factor(t, kinds[nid], t["jobs"][job_of[nid]], *(a[nid] for a in ang))
    return y


class _Walk:
    """The tree's structure as KE's walk reads it: level l is node
    n_nodes - 1 - l; each non-root node C keeps the powers A[C, l] =
    base_C ** (the degree its subtree's levels <= l give C), base_C the
    cosine (first child of a 'c' node) or sine of its parent's angle."""

    def __init__(self, t):
        self.nn = t["n_nodes"]
        self.nl = self.nn - 1
        self.kind = {nid: kind for kind, nid, _, _ in t["nodes"]}
        self.children = {nid: [a0] if kind == KIND_B else [a0, a1] if kind == KIND_C else []
                         for kind, nid, a0, a1 in t["nodes"]}
        self.parent = {ch: nid for nid, chs in self.children.items() for ch in chs}
        size = {}
        for _, nid, _, _ in t["nodes"]:  # children first
            size[nid] = 1 + sum(size[ch] for ch in self.children[nid])
        self.lo = {nid: self.level(nid) - size[nid] + 1 for nid in self.kind if nid != 0}

    def level(self, nid):
        return self.nn - 1 - nid

    def node(self, lv):
        return self.nn - 1 - lv

    def holds(self, lv):
        """The non-root nodes whose power a step at level lv moves."""
        return [nid for nid in self.lo if self.lo[nid] <= lv <= self.level(nid)]


def ke_walk(t, wt, v, rad, w, starts=(0,)):
    """KE's loop at points v [d, P] with the clamped radial table rad
    [P, n_end] and the density w [H] in KE's order (`ke_perm`): u [P], and
    the seed and subtree steps it took (a level's step, the restart of a
    'b' or 'c' level (its seed), a root seed: each 1; an 'a' level restarts
    at the constant 1 / sqrt(2 pi)).  The child states in walk order, each level's state
    carried: a step at one level, the levels inside it restarted from the
    powers of the levels outside (as the kernel's static-shape instances
    do); at each entry of `starts` (a few-point lane's first) every level
    is rebuilt from its restart by its steps."""
    ang = tree_angles(t, v)
    x, c, s = ang
    if t["root_kind"] == KIND_A:
        n_j, woff = wt["walk"][0][1], wt["walk"][0][2]
        u = 0j
        for j in range(n_j):
            job = t["jobs"][t["cs"][0][0] + j]
            u = u + node_factor(t, KIND_A, job, x[0], c[0], s[0]) * rad[:, abs(job[2])] \
                * w[woff + j]
        return u, 0
    tr = _Walk(t)
    n_steps = 0
    A, pa, pn, pm, row, prod = {}, {}, {}, {}, {}, {}

    def base(nid):
        par = tr.parent[nid]
        first = tr.kind[par] == KIND_C and tr.children[par][0] == nid
        return c[par] if first else s[par]

    def seed(nid, p0, norm):
        """The prefactor of node nid's job from its children's powers, times p0."""
        chs = tr.children[nid]
        if tr.kind[nid] == KIND_B:
            pref = A[chs[0], tr.level(chs[0])]
        else:
            pref = norm * A[chs[0], tr.level(chs[0])] * A[chs[1], tr.level(chs[1])]
        return pref * p0

    def restart(lv, e):
        nonlocal n_steps
        nid = tr.node(lv)
        for hold in tr.holds(lv):
            A[hold, lv] = 1.0 if lv == tr.lo[hold] else A[hold, lv - 1]
        if tr.kind[nid] == KIND_A:
            pa[lv] = 1.0 / np.sqrt(2.0 * np.pi) + 0j
        else:
            f = t["jobs"][wt["wjob"][e][nid]][0]
            pn[lv], pm[lv], row[lv] = seed(nid, *t["famr"][f]), 0.0, t["fam"][f]
            n_steps += 1

    def step(lv, conj):
        nid = tr.node(lv)
        if tr.kind[nid] == KIND_A:
            pa[lv] = pa[lv] * (c[nid] + 1j * (-s[nid] if conj else s[nid]))
        else:
            pn[lv], pm[lv] = jacobi_step(t, row[lv], x[nid], pn[lv], pm[lv])
            row[lv] += 1
        for hold in tr.holds(lv):
            for _ in range(2 if tr.kind[nid] == KIND_C else 1):
                A[hold, lv] = A[hold, lv] * base(hold)

    def products(first):
        for lv in range(first, tr.nl):
            f = pa[lv] if tr.kind[tr.node(lv)] == KIND_A else pn[lv]
            prod[lv] = f if lv == 0 else prod[lv - 1] * f

    neg = {}
    u = 0j
    for e, (op, n_j, woff, l0) in enumerate(wt["walk"]):
        if e in starts:  # every level rebuilt: restart, then its steps
            for lv in range(tr.nl):
                restart(lv, e)
                _, steps, p1, _ = t["jobs"][wt["wjob"][e][tr.node(lv)]]
                n = abs(int(p1)) if tr.kind[tr.node(lv)] == KIND_A else int(steps)
                neg[lv] = tr.kind[tr.node(lv)] == KIND_A and p1 < 0
                for _ in range(n):
                    step(lv, neg[lv])
                n_steps += n
            products(0)
        else:
            lv, flip = op & 255, op >> 8
            if flip:
                restart(lv, e)
                neg[lv] = True
            step(lv, neg.get(lv, False))
            n_steps += 1
            for inner in range(lv + 1, tr.nl):
                restart(inner, e)
                neg[inner] = False
            products(lv)
        row0, (p0, norm) = wt["wfam"][e][3], wt["wroot"][e][:2]  # the root's first row
        assert (wt["wroot"][e][2:5] == t["coef"][row0][:3]).all()
        root = t["nodes"][-1]  # the root comes last (children first)
        pr, pp = seed(0, p0, norm), 0.0
        n_steps += 1
        acc = 0j
        for j in range(n_j):
            acc = acc + (pr * rad[:, l0 + t["root_step"] * j]) * w[woff + j]
            if j + 1 < n_j:
                pr, pp = jacobi_step(t, row0 + j, x[0], pr, pp)
        assert root[1] == 0
        u = u + acc * prod[tr.nl - 1]
    return u, n_steps


def _case(btype, n_end, complex_k, seed=3):
    """(tree, n_end, x [d, 1, P], per-k centers [K, B, d], k [K], w [K, B, H])
    with unit spheres and points outside all of them."""
    rng = np.random.default_rng(seed)
    c = create_from_branching_types(btype)
    d, n_k, n_b = c.c_ndim, 2, 3
    ell = basis(c, n_end).n_root
    centers = rng.normal(size=(n_k, n_b, d)) * 2.0
    u = rng.normal(size=(d, 1, 12))
    x = u / np.linalg.norm(u, axis=0) * rng.uniform(8.0, 12.0, size=12)
    k = np.array([0.8, 1.7]) + (0.2j if complex_k else 0.0)
    w = (rng.normal(size=(n_k, n_b, len(ell))) + 1j * rng.normal(size=(n_k, n_b, len(ell))))
    return (c, n_end, torch.as_tensor(x), torch.as_tensor(centers), torch.as_tensor(k),
            torch.as_tensor(w * np.exp(-0.2 * ell)))


def _walk_all(c, n_end, x, centers, k, w, starts=(0,)):
    """KE's walk at every (point, k, ball): [P, K, B], in float64.  The
    radial factor is the plain version's own (in the inputs' dtype), taken
    over the same tensor shape as there: torch's CPU kernels may round the last bit of a
    vectorised and a scalar element apart, and the cylinder seeds of even
    d (K5's) carry such a bit of k r into 1e-11 of h_n."""
    t = program_numpy(c, n_end)
    wt = ke_walk_numpy(c, n_end)
    d = c.c_ndim
    n_k, n_b, _ = w.shape
    rel = x[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, P, B]
    rad = _h_clamped(d, n_end, k[:, None, None] * tree_radius(c, rel)).to(torch.complex128)
    out = np.zeros((x.shape[-1], n_k, n_b), dtype=complex)
    for kk in range(n_k):
        for b in range(n_b):
            out[:, kk, b] = ke_walk(t, wt, rel[:, kk, :, b].double().numpy(),
                                    rad[kk, :, b].numpy(),
                                    w[kk, b].to(torch.complex128).numpy()[wt["ke_perm"]],
                                    starts)[0]
    return out


@pytest.mark.parametrize("btype,n_end", TREES)
def test_ke_walk_equals_harmonic_sum(btype, n_end):
    """KE's loop over the program's tables equal to `harmonic_sum` (the
    plain version on the CPU) within 1e-12 of the largest |u|, real and
    complex k, per ball and summed."""
    for complex_k in (False, True):
        c, n, x, centers, k, w = _case(btype, n_end, complex_k)
        got = _walk_all(c, n, x, centers, k, w)
        ref = harmonic_sum(c, n, x, centers, k, w, per_ball=True).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
        ref_sum = harmonic_sum(c, n, x, centers, k, w).numpy()
        np.testing.assert_allclose(got.sum(-1), ref_sum, rtol=0,
                                   atol=1e-12 * np.abs(ref_sum).max())


@pytest.mark.parametrize("btype,n_end", [("bpa", 9), ("bba", 6), ("caa", 7), ("bcaa", 4),
                                         ("bbba", 4)])
def test_ke_walk_few_point_runs_equal_harmonic_sum(btype, n_end):
    """The few-point mode's lanes: the walk cut into `ke_runs`' 32 runs,
    each run's first child state rebuilt from every level's restart by its
    steps, then carried; within 1e-12 of `harmonic_sum` per ball."""
    c, n, x, centers, k, w = _case(btype, n_end, True)
    starts = set(ke_runs(c, n, 32)[:-1].tolist())
    assert len(starts) > 1
    got = _walk_all(c, n, x, centers, k, w, starts)
    ref = harmonic_sum(c, n, x, centers, k, w, per_ball=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("btype,n_end", [("bpa", 32), ("bba", 20)])
def test_walk_costs_at_most_one_step_a_node_per_child_state(btype, n_end):
    """Along the walk, the seed and subtree work (a level's step or
    restart, the root's seed) totals at most n_cs x n_nodes steps: 63 x 2
    for 'bpa' at n_end=32 (was 1,984 serial steps from the seeds), 400 x 3
    for 'bba' at n_end=20 (was 12,920)."""
    c = create_from_branching_types(btype)
    t, wt = program_numpy(c, n_end), ke_walk_numpy(c, n_end)
    v = np.random.default_rng(1).normal(size=(c.c_ndim, 1))
    _, n_steps = ke_walk(t, wt, v, np.ones((1, n_end)), np.ones(t["h_num"]))
    assert n_steps <= t["n_cs"] * t["n_nodes"]
    assert n_steps >= t["n_cs"]


@pytest.mark.parametrize("btype,n_end", [("a", 9), ("bpa", 12), ("bba", 7), ("caa", 8),
                                         ("bcaa", 5), ("bbba", 5), ("cbaba", 4)])
def test_ke_order_covers_every_harmonic_once(btype, n_end):
    """KE's order `ke_perm` is a permutation of the H harmonics: child
    state by child state in walk order, each one's program entries in
    order; the walk's entries tile it; its first child state is every
    level's first and each next one is one step at one level."""
    c = create_from_branching_types(btype)
    t, wt = program_numpy(c, n_end), ke_walk_numpy(c, n_end)
    assert sorted(wt["ke_perm"].tolist()) == list(range(t["h_num"]))
    walk = wt["walk"]
    assert (walk[:, 2] == np.concatenate([[0], np.cumsum(walk[:-1, 1])])).all()
    assert walk[:, 1].sum() == t["h_num"] and len(walk) == t["n_cs"]
    # each entry's block is its child state's program entries
    order = [int(np.flatnonzero((t["csjob"] == row).all(1))[0]) for row in wt["wjob"]]
    assert sorted(order) == list(range(t["n_cs"]))
    for (_, n_j, woff, l0), cs in zip(walk, order):
        assert (t["cs"][cs, 1], t["cs"][cs, 3]) == (n_j, l0)
        a = t["cs"][cs, 2]
        assert (wt["ke_perm"][woff : woff + n_j] == t["perm"][a : a + n_j]).all()
    nl = t["n_nodes"] - 1
    assert ((walk[:, 0] & 255) < max(nl, 1)).all() and walk[0, 0] == 0
    runs = ke_runs(c, n_end, 32)
    assert runs[0] == 0 and runs[-1] == t["n_cs"] and (np.diff(runs) >= 0).all()


# sha256 of cs, csjob and perm (the child states of `_coax_tables` that K3
# reads) as the program built them before KE's walk was added
_CHILD_STATE_DIGESTS = {
    ("bpa", 32): "d96bfb2a24d8361c863edc9b5d75523a",
    ("bba", 20): "ef3fb8e6d960ca240cafcf67c4a6cbb6",
    ("caa", 14): "036770843d250a40aa048e7d071ad033",
    ("bcaa", 8): "1a79c843157420c4645b366962eb1018",
    ("bbba", 12): "d12a48c1a2a97e11eccef8ffde782a54",
}


@pytest.mark.parametrize("btype,n_end", sorted(_CHILD_STATE_DIGESTS))
def test_child_state_tables_are_unchanged(btype, n_end):
    """cs, csjob and perm (and their dtypes) are bitwise what they were
    before KE's walk: K3 and `_coax_tables`' ids read them."""
    import hashlib

    t = program_numpy(create_from_branching_types(btype), n_end)
    assert (t["cs"].dtype, t["csjob"].dtype, t["perm"].dtype) == (np.int32, np.int32, np.int64)
    h = hashlib.sha256()
    for key in ("cs", "csjob", "perm"):
        h.update(t[key].tobytes())
    assert h.hexdigest()[:32] == _CHILD_STATE_DIGESTS[(btype, n_end)]


def test_shape_codes_name_the_kernel_instances():
    """KE's instance per tree shape: the node kinds in pre-order for at
    most 4 nodes, 0 (generic) above; the program's device tables carry the
    walk."""
    codes = {b: shape_code(create_from_branching_types(b))
             for b in ("a", "ba", "bpa", "bba", "bpbpa", "caa", "bcaa", "bbba", "cbaba")}
    assert codes == {"a": 256, "ba": 513, "bpa": 513, "bba": 773, "bpbpa": 773, "caa": 770,
                     "bcaa": 1033, "bbba": 1045, "cbaba": 0}
    c = create_from_branching_types("bcaa")
    p, wt = harmonic_program(c, 5, torch.float64, "cpu"), ke_walk_numpy(c, 5)
    assert p.shape == 1033 and p.walk.dtype == torch.int32
    for key in ("walk", "wfam", "wroot", "wstep", "wjob", "ke_perm"):
        assert np.array_equal(getattr(p, key).numpy(), wt[key])


@pytest.mark.parametrize("btype", ["bpa", "caa"])
def test_ke_walk_near_a_sphere_where_float32_h_overflows(btype):
    """Points within 0.02 of a unit sphere at k = 0.1 and n_end = 20, where
    |h_n| passes float32's range: the complex64 plain version stays finite
    (the clamp, with the density underflowed as a solve leaves it), and
    the walk with the same float32 radial factor agrees within 1e-5."""
    rng = np.random.default_rng(9)
    c = create_from_branching_types(btype)
    n_end, d = 20, c.c_ndim
    ell = basis(c, n_end).n_root
    centers = torch.as_tensor(np.zeros((1, 1, d)), dtype=torch.float32)
    u = rng.normal(size=(d, 1, 8))
    x = torch.as_tensor(u / np.linalg.norm(u, axis=0) * 1.02, dtype=torch.float32)
    k = torch.tensor([0.1], dtype=torch.float32)
    w = torch.as_tensor((rng.normal(size=(1, 1, len(ell))) + 0j) * 10.0 ** (-3.0 * ell),
                        dtype=torch.complex64)
    hm, he = spherical_h_scaled(d, n_end, torch.tensor([0.102 + 0j], dtype=torch.complex128))
    assert float((he[0, -1] + torch.log(hm[0, -1].abs()))) > np.log(np.finfo(np.float32).max)
    ref = harmonic_sum(c, n_end, x, centers, k, w).numpy()
    assert np.isfinite(ref).all()
    got = _walk_all(c, n_end, x, centers, k, w)
    np.testing.assert_allclose(got.sum(-1), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("btype,n_end", [("ba", 6), ("bba", 5), ("bcaa", 4)])
def test_child_states_are_coax_tables_ids(btype, n_end):
    """The program's child states are `_coax_tables`' ids, each h in exactly
    one program entry, its root degree l0 + step j."""
    c = create_from_branching_types(btype)
    t = program_numpy(c, n_end)
    cs_ids = _coax_tables(c, n_end)[5]
    n_root = basis(c, n_end).n_root
    assert sorted(t["perm"].tolist()) == list(range(t["h_num"]))
    for i, (_, n_j, woff, l0) in enumerate(t["cs"]):
        hs = t["perm"][woff : woff + n_j]
        assert (cs_ids[hs] == i).all()
        assert (n_root[hs] == l0 + t["root_step"] * np.arange(n_j)).all()


def test_tree_radius_is_from_cartesians_r():
    """KE's wrapper takes k |x - c| from `tree_radius`, bitwise the plain
    version's `from_cartesian(...)["r"]` (K5's even-d seeds amplify an ulp)."""
    rng = np.random.default_rng(2)
    for btype in ("a", "bpa", "bba", "caa", "bcaa"):
        c = create_from_branching_types(btype)
        x = torch.as_tensor(rng.normal(size=(c.c_ndim, 5, 7)))
        assert torch.equal(tree_radius(c, x), from_cartesian(c, x)["r"])


def test_program_device_tables_match_the_host_ones():
    """`harmonic_program` puts the host tables on a device in the asked
    real dtype (float32 coefficients for complex64)."""
    c = create_from_branching_types("bcaa")
    t = program_numpy(c, 5)
    p = harmonic_program(c, 5, torch.float32, "cpu")
    assert p.coef.dtype == torch.float32 and p.csjob.dtype == torch.int32
    assert np.array_equal(p.csjob.numpy(), t["csjob"])
    assert np.array_equal(p.perm.numpy(), t["perm"])
    np.testing.assert_allclose(p.coef.numpy(), t["coef"], rtol=1e-7)


@pytest.mark.parametrize("btype,n_end", [("bba", 5), ("caa", 6), ("bcaa", 4)])
def test_program_factors_match_jax_harmonics(btype, n_end):
    """Every Y_h as the program's factor product (K3's evaluation) against
    the JAX package's harmonics, 1e-13."""
    rng = np.random.default_rng(4)
    c = create_from_branching_types(btype)
    t = program_numpy(c, n_end)
    v = rng.normal(size=(c.c_ndim, 6))
    ang = tree_angles(t, v)
    got = np.stack([factor_product(t, t["hjob"][h], 0, ang) for h in range(t["h_num"])], -1)
    cj = j_tree(btype)
    ref = tonp(j_harmonics(cj, j_from_cartesian(cj, jnp.asarray(v)), n_end))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("btype,n_end,tol", [("bpa", 6, 1e-11), ("caa", 5, 1e-9)])
def test_biem_u_on_general_trees_matches_jax(btype, n_end, tol):
    """biem_u's near field (KE's path: `harmonic_sum` -> `harmonic_eval`) and
    far field against the JAX package's biem_u for a random density, per
    ball: 1e-11 of the largest |u| in 3D, 1e-9 in 4D, where the two
    packages' cylinder-seed series (even d) differ by ~1e-11 relative."""
    rng = np.random.default_rng(6)
    c_t, c_j = create_from_branching_types(btype), j_tree(btype)
    d = c_t.c_ndim
    h = basis(c_t, n_end).num
    centers = np.array([[0.0] * (d - 1) + [2.0], [0.0] * (d - 1) + [-2.0]])
    dens = rng.normal(size=(2, h)) + 1j * rng.normal(size=(2, h))
    x = rng.normal(size=(d, 5)) * 6.0 + 8.0
    common = dict(kind="outer", n_end=n_end)
    res_t = SimpleNamespace(c=c_t, density=torch.as_tensor(dens), centers=torch.as_tensor(centers),
                            radii=torch.ones(2, dtype=torch.float64),
                            k=torch.tensor(1.3, dtype=torch.float64),
                            eta=torch.tensor(1.0, dtype=torch.float64), **common)
    res_j = SimpleNamespace(c=c_j, density=C(jnp.asarray(dens.real), jnp.asarray(dens.imag)),
                            centers=jnp.asarray(centers), radii=jnp.ones(2),
                            k=jnp.asarray(1.3), eta=jnp.asarray(1.0), **common)
    for far in (False, True):
        xx = x / np.linalg.norm(x, axis=0) if far else x
        got = biem_u(res_t, torch.as_tensor(xx), far_field=far, per_ball=True).numpy()
        ref = tonp(j_biem_u(res_j, jnp.asarray(xx), far_field=far, per_ball=True))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_harmonics_unchanged_by_the_program():
    """The plain `harmonics` (the CPU path of both kernels' oracles) equals
    the program's factor product at random points, 'bcaa' n_end = 5."""
    rng = np.random.default_rng(8)
    c = create_from_branching_types("bcaa")
    t = program_numpy(c, 5)
    v = rng.normal(size=(c.c_ndim, 4))
    ang = tree_angles(t, v)
    got = np.stack([factor_product(t, t["hjob"][h], 0, ang) for h in range(t["h_num"])], -1)
    ref = harmonics(c, from_cartesian(c, torch.as_tensor(v)), 5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)
