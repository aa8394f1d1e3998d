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
    program_numpy,
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


def ke_walk(t, v, rad, w):
    """KE's loop at points v [d, P] with the clamped radial table rad
    [P, n_end] and the density w [H] in program order: u [P]."""
    ang = tree_angles(t, v)
    x0, c0, s0 = (a[0] for a in ang)
    u = 0j
    for cs, (job0, n_j, woff, l0) in enumerate(t["cs"]):
        acc = 0j
        if t["root_kind"] == KIND_A:
            for j in range(n_j):
                m = t["jobs"][job0 + j][2]
                acc = acc + node_factor(t, KIND_A, t["jobs"][job0 + j], x0, c0, s0) \
                    * rad[:, abs(m)] * w[woff + j]
            u = u + acc
            continue
        kind = t["nodes"][-1][0]  # the root comes last (children first)
        job = t["jobs"][job0]
        pn, pm = job_seed(t, kind, job, c0, s0), 0.0
        for j in range(n_j):
            acc = acc + (pn * rad[:, l0 + t["root_step"] * j]) * w[woff + j]
            if j + 1 < n_j:
                pn, pm = jacobi_step(t, t["fam"][job[0]] + j, x0, pn, pm)
        u = u + acc * factor_product(t, t["csjob"][cs], 1, ang)
    return u


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


def _walk_all(c, n_end, x, centers, k, w):
    """KE's walk at every (point, k, ball): [P, K, B], in float64.  The
    radial factor is the plain version's own (in the inputs' dtype), taken
    over the same tensor shape as there: torch's CPU kernels may round the last bit of a
    vectorised and a scalar element apart, and the cylinder seeds of even
    d (K5's) carry such a bit of k r into 1e-11 of h_n."""
    t = program_numpy(c, n_end)
    d = c.c_ndim
    n_k, n_b, _ = w.shape
    rel = x[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, P, B]
    rad = _h_clamped(d, n_end, k[:, None, None] * tree_radius(c, rel)).to(torch.complex128)
    out = np.zeros((x.shape[-1], n_k, n_b), dtype=complex)
    for kk in range(n_k):
        for b in range(n_b):
            out[:, kk, b] = ke_walk(t, rel[:, kk, :, b].double().numpy(), rad[kk, :, b].numpy(),
                                    w[kk, b].to(torch.complex128).numpy()[t["perm"]])
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
