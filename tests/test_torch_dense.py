"""The port's dense route against the JAX package, on the CPU in float64.

translation_matrix / coaxial_sr / sr_rotation / sr_scaled, the unscaled
radial rows, the dense assembly in both layouts (KD's plain version), the
direct, dense-GMRES and diagonal solves, the matrix-only call and the route
chooser, from the same numpy inputs on both sides.

Tolerances: translation entries agree to 1e-10 of the largest entry of
their (degree row, degree column) block, where magnitudes are alike
(|SR| ~ |h_{l+l'}(kt)|); the radial rows are the same recurrences (1e-12);
assembled matrices agree to 1e-10 of the largest entry of each sphere-pair
block; solves meet the float64 GMRES tolerance 1e-11, so densities agree
to ~1e-9.  The JAX package's values are committed in
tests/golden/test_torch_dense.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`): each is a JAX compile of 10 s
to 1.5 minutes on a cold CPU.
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.biem._core import _radial_rows as j_radial_rows
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation import translation_matrix as j_translation_matrix
from biem_helmholtz_sphere_tpu.translation._rotation import coaxial_sr as j_coaxial_sr
from biem_helmholtz_sphere_tpu.translation._rotation import sr_rotation as j_sr_rotation
from biem_helmholtz_sphere_tpu.translation._scaled import sr_scaled as j_sr_scaled
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types, from_cartesian
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.ops import kernels
from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble
from biem_helmholtz_sphere_tpu_torch.special import spherical_jh_all
from biem_helmholtz_sphere_tpu_torch.translation import (
    coaxial_sr,
    sr_rotation,
    sr_scaled,
    translation_matrix,
)
from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coaxial_sr_plain

F64 = dict(dtype=torch.float64)
KS = np.array([1.3, 2.1])


def _lattice(n_side=4, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _offsets(rng, d):
    """[d, 8] offsets: random, along and against the root axis, and a
    repeated one (so the radii deduplicate)."""
    t = rng.normal(size=(d, 5)) * 3.0
    e = np.eye(d)[:, -1:]
    return np.concatenate([t, 3.0 * e, -2.5 * e, t[:, :1]], axis=1)


def _assert_degree_blocks(got, ref, ell, rtol):
    """|got - ref| <= rtol * (largest |ref| of its (degree, degree) block)."""
    for lr in np.unique(ell):
        for lc in np.unique(ell):
            g = got[..., ell == lr, :][..., ell == lc]
            r = ref[..., ell == lr, :][..., ell == lc]
            scale = np.abs(r).max(axis=(-2, -1), keepdims=True)
            assert (np.abs(g - r) <= rtol * scale).all(), (lr, lc)


def jax_golden():
    """The JAX package's values the tests below read: translations, the
    coaxial and rotation factors, the radial rows, the assembled matrices
    and the direct, force_matrix and one-sphere solves (each a JAX compile
    of 10 s to 1.5 minutes on a cold CPU)."""
    out = {}
    for btype, n_end in TRANSLATIONS:
        cj = j_tree(btype)
        t = _offsets(np.random.default_rng(11), cj.c_ndim)
        for kind in ("SR", "RR"):
            for method in (None, "rotation"):
                out[f"translation {btype} {kind} {method}"] = tonp(j_translation_matrix(
                    cj, t, n_end, KS[:, None], kind=kind, method=method))
    out["translation gumerov"] = tonp(j_translation_matrix(j_tree("ba"), np.ones((3, 1)), 3,
                                                           1.0, method="gumerov"))
    for kind in ("SR", "RR"):
        out[f"coaxial {kind}"] = tonp(j_coaxial_sr(j_tree("ba"), COAX_R, 7, KS[:, None],
                                                   kind=kind))
    for btype, n_end in ROTATIONS:
        cj = j_tree(btype)
        t = _offsets(np.random.default_rng(13), cj.c_ndim)
        out[f"sr_rotation {btype}"] = tonp(j_sr_rotation(cj, j_from_cartesian(cj, t), n_end,
                                                         KS[:, None], t_cart=t))
        m_j, s_j = j_sr_scaled(cj, j_from_cartesian(cj, t), n_end, KS[:, None])
        out[f"sr_scaled mant {btype}"], out[f"sr_scaled S {btype}"] = tonp(m_j), np.asarray(s_j)
    radii, eta, alpha, beta = _radial_rows_args()
    for i, r in enumerate(j_radial_rows(j_tree("ba"), 8, radii, KS, eta, C.of(alpha),
                                        C.of(beta))):
        out[f"radial rows {i}"] = tonp(r)
    for geometry in _GEOMETRIES:
        for stable in (True, False):
            out[f"matrix {geometry} {stable}"] = _jax_matrix(
                geometry, _assembly_n_end(geometry), stable)
    out["robin lattice density"] = _robin_lattice_jax()
    ref = _force_matrix_jax()
    out["force_matrix matrix"], out["force_matrix density"] = tonp(ref.matrix), tonp(ref.density)
    for stable in (True, False):
        ref = _one_sphere_jax(stable)
        out[f"one sphere density {stable}"] = tonp(ref.density)
        out[f"one sphere uscat {stable}"] = tonp(ref.uscat(ONE_X))
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_dense")


def _assert_pair_blocks(got, ref, rtol=1e-10):
    """[..., B, H, B', H'] matrices: within rtol of each (b, b') block's
    largest entry."""
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=(-3, -1), keepdims=True)
    assert (np.abs(got - ref) <= rtol * scale).all()


TRANSLATIONS = [("ba", 6), ("bpa", 5), ("bbba", 3)]


@pytest.mark.parametrize("btype,n_end", TRANSLATIONS)
@pytest.mark.parametrize("kind", ["SR", "RR"])
@pytest.mark.parametrize("method", [None, "rotation"])
def test_translation_matrix_matches_jax(jax_values, btype, n_end, kind, method):
    rng = np.random.default_rng(11)
    c = create_from_branching_types(btype)
    t = _offsets(rng, c.c_ndim)
    k = KS[:, None]
    got = translation_matrix(c, torch.tensor(t), n_end, torch.tensor(k), kind=kind,
                             method=method).numpy()
    ref = jax_values[f"translation {btype} {kind} {method}"]
    assert got.shape == ref.shape == (2, 8, basis(c, n_end).num, basis(c, n_end).num)
    _assert_degree_blocks(got, ref, basis(c, n_end).n_root, 1e-10)


def test_translation_matrix_from_a_spherical_mapping():
    rng = np.random.default_rng(12)
    c = create_from_branching_types("ba")
    t = torch.tensor(_offsets(rng, 3))
    k = torch.tensor(KS[:, None])
    by_cart = translation_matrix(c, t, 5, k)
    by_sph = translation_matrix(c, from_cartesian(c, t), 5, k)
    scale = by_cart.abs().amax(dim=(-2, -1), keepdim=True)
    assert bool(((by_sph - by_cart).abs() <= 1e-12 * scale).all())


def test_translation_matrix_validates_as_jax(jax_values, monkeypatch):
    """The JAX package's argument checks; "gumerov" on 'ba' matches the
    JAX package's (entries within 1e-12 of their degree block's largest);
    given no tensor it runs on the card (and raises without one)."""
    c = create_from_branching_types("ba")
    t, k = torch.ones(3, 1, **F64), torch.tensor(1.0, **F64)
    with pytest.raises(ValueError, match="unknown translation method"):
        translation_matrix(c, t, 3, k, method="bogus")
    with pytest.raises(ValueError, match="plane_wave"):
        translation_matrix(c, t, 3, k, method="plane_wave")
    with pytest.raises(ValueError, match="kind"):
        translation_matrix(c, t, 3, k, kind="SS")
    got = translation_matrix(c, t, 3, k, method="gumerov").numpy()
    ref = jax_values["translation gumerov"]
    assert got.shape == ref.shape == (1, 9, 9)
    _assert_degree_blocks(got, ref, basis(c, 3).n_root, 1e-12)
    # the band scan (ported since): "triplet" and n_end_add != n_end
    assert translation_matrix(c, t, 3, k, method="triplet").shape == (1, 9, 9)
    assert translation_matrix(c, t, 3, k, n_end_add=4).shape == (1, 9, 16)
    with pytest.raises(ValueError, match="'b'/'bp'-rooted"):
        translation_matrix(create_from_branching_types("caa"), torch.ones(4, 1, **F64), 3, k,
                           method="rotation")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        translation_matrix(c, np.ones((3, 1)), 3, 1.0)


COAX_R = np.array([4.0, 4.0 * np.sqrt(2.0), 8.0])


@pytest.mark.parametrize("kind", ["SR", "RR"])
def test_coaxial_sr_matches_jax(jax_values, kind):
    """coaxial_sr runs K2's plain version with zero exponents (its CPU
    path); the JAX package's dense band sum and the port's plain
    coaxial_sr formula give the same values."""
    c = create_from_branching_types("ba")
    n_end = 7
    r = COAX_R
    k = KS[:, None]
    got = coaxial_sr(c, torch.tensor(r), n_end, torch.tensor(k), kind=kind).numpy()
    ref = jax_values[f"coaxial {kind}"]
    ell = basis(c, n_end).n_root
    _assert_degree_blocks(got, ref, ell, 1e-10)
    j, _, h, _ = spherical_jh_all(3, 2 * n_end - 1, torch.tensor(k * r))
    plain = _coaxial_sr_plain(c, h if kind == "SR" else j, n_end).numpy()
    _assert_degree_blocks(plain, ref, ell, 1e-10)


ROTATIONS = [("ba", 6), ("bpa", 5)]


@pytest.mark.parametrize("btype,n_end", ROTATIONS)
def test_sr_rotation_and_sr_scaled_match_jax(jax_values, btype, n_end):
    rng = np.random.default_rng(13)
    c = create_from_branching_types(btype)
    t = _offsets(rng, c.c_ndim)
    k = KS[:, None]
    ell = basis(c, n_end).n_root
    got = sr_rotation(c, None, n_end, torch.tensor(k), t_cart=torch.tensor(t)).numpy()
    ref = jax_values[f"sr_rotation {btype}"]
    _assert_degree_blocks(got, ref, ell, 1e-10)
    m, s = sr_scaled(c, from_cartesian(c, torch.tensor(t)), n_end, torch.tensor(k))
    m_j, s_j = jax_values[f"sr_scaled mant {btype}"], jax_values[f"sr_scaled S {btype}"]
    np.testing.assert_allclose(s.numpy(), s_j, rtol=1e-12, atol=1e-12)
    _assert_degree_blocks(m.numpy(), m_j, ell, 1e-10)
    # mant * exp(S) is the unscaled operator
    _assert_degree_blocks((m * torch.exp(s)).numpy(), ref, ell, 1e-10)


def _radial_rows_args():
    """(radii, eta, alpha, beta) of test_radial_rows_match_jax (n_end = 8)."""
    rng = np.random.default_rng(14)
    radii = rng.uniform(0.5, 1.5, size=(2, 3))
    alpha = rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))
    beta = rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))
    return radii, np.array([1.0, 0.7]), alpha, beta


def test_radial_rows_match_jax(jax_values):
    c = create_from_branching_types("ba")
    radii, eta, alpha, beta = _radial_rows_args()
    got = _core._radial_rows(c, 8, torch.tensor(radii), torch.tensor(KS),
                             torch.tensor(eta), torch.tensor(alpha), torch.tensor(beta))
    for i, g in enumerate(got):
        r = jax_values[f"radial rows {i}"]
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12 * np.abs(r).max())


# geometries of the assembly: a 4x4 lattice (24 distinct offsets of 120
# pairs, uniform radii), 3 random spheres with different radii (no repeat:
# the JAX package's per-pair exponents), one sphere
_GEOMETRIES = {
    "lattice": (_lattice(), np.ones(16)),
    "random": (np.array([[0.3, -0.2, 0.1], [4.1, 1.0, -0.6], [-1.2, 3.9, 2.2]]),
               np.array([0.9, 1.2, 0.7])),
    "one": (np.array([[0.5, -0.5, 1.0]]), np.array([0.8])),
}


def _assembly_n_end(geometry):
    return 4 if geometry == "lattice" else 6


def _jax_matrix(geometry, n_end, stable):
    """The JAX package's matrix (beta as a float64 array: it takes a
    Python float as float32); committed by `jax_golden`."""
    centers, radii = _GEOMETRIES[geometry]
    n_b = len(radii)
    calc = j_biem(j_tree("ba"), centers=np.broadcast_to(centers, (2, n_b, 3)),
                  radii=np.broadcast_to(radii, (2, n_b)), k=KS, n_end=n_end, alpha=1.0,
                  beta=np.full((2, n_b), 0.3), eta=np.array([1.0, 0.7]), stable=stable)
    return tonp(calc.matrix)


@pytest.mark.parametrize("geometry", list(_GEOMETRIES))
@pytest.mark.parametrize("stable", [True, False])
def test_assemble_matches_jax_in_both_layouts(jax_values, geometry, stable):
    n_end = _assembly_n_end(geometry)
    centers, radii = _GEOMETRIES[geometry]
    n_b = len(radii)
    ref = jax_values[f"matrix {geometry} {stable}"]  # [K, B, H, B', H']
    if n_b == 1:  # the JAX package shapes its one-sphere matrix [K, 1, 1, H, H]
        ref = ref.reshape(2, 1, n_end * n_end, 1, n_end * n_end)
    args = (create_from_branching_types("ba"), n_end, centers,
            torch.tensor(np.broadcast_to(radii, (2, n_b)).copy()), torch.tensor(KS),
            torch.tensor([1.0, 0.7], **F64), torch.ones(2, n_b, dtype=torch.complex128),
            torch.full((2, n_b), 0.3, dtype=torch.complex128))
    got = _core._assemble(*args, stable=stable).numpy()
    _assert_pair_blocks(got, ref)
    pairs = _core._assemble(*args, stable=stable, pair_major=True).numpy()
    _assert_pair_blocks(pairs.transpose(0, 1, 3, 2, 4), ref)
    # the biem() call with no incident field returns the same matrix
    calc = biem(create_from_branching_types("ba"),
                centers=torch.tensor(np.broadcast_to(centers, (2, n_b, 3)).copy()),
                radii=args[3], k=args[4], n_end=n_end, alpha=1.0, beta=0.3, eta=args[5],
                stable=stable)
    assert calc.density is None and calc.relres is None
    _assert_pair_blocks(calc.matrix.numpy(), ref)


def test_dense_assemble_plain_against_a_direct_gather():
    """KD's plain version against entry-by-entry loops, in both layouts."""
    rng = np.random.default_rng(15)
    n_k, n_b, n_o, h = 2, 4, 3, 5

    def randc(*shape):
        return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))

    table, rowf, colf, diag = randc(n_k, n_o, h, h), randc(n_k, n_b, h), randc(n_k, n_b, h), \
        randc(n_k, n_b, h)
    pid = torch.tensor(rng.integers(0, n_o, size=(n_b, n_b)))
    sgn = torch.tensor((-1.0) ** np.arange(h))
    ref = torch.zeros(n_k, n_b, n_b, h, h, dtype=torch.complex128)
    for k in range(n_k):
        for b in range(n_b):
            for bp in range(n_b):
                for i in range(h):
                    for j in range(h):
                        if b == bp:
                            ref[k, b, bp, i, j] = diag[k, b, i] if i == j else 0.0
                            continue
                        s = sgn[i] * sgn[j] if b > bp else 1.0
                        ref[k, b, bp, i, j] = (rowf[k, b, i] * table[k, pid[b, bp], i, j]
                                               * colf[k, bp, j] * s)
    got = dense_assemble(table, pid, rowf, colf, sgn, diag, pair_major=True)
    torch.testing.assert_close(got, ref, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(_dense_assemble_plain(table, pid, rowf, colf, sgn, diag, False),
                               ref.transpose(2, 3), rtol=1e-14, atol=1e-14)


def _readme(dtype, **kw):
    f = dict(dtype=dtype)
    uin, _ = plane_wave(k=torch.tensor(1.0, **f), direction=torch.tensor([1.0, 0.0, 0.0], **f))
    return biem(create_from_branching_types("ba"),
                centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f),
                radii=torch.ones(2, **f), k=torch.tensor(1.0, **f), n_end=6, uin=uin, **kw)


def test_readme_golden_on_the_default_route():
    """The reference README call with no solver and no stable argument:
    a direct LU (stable=False in float64, stable in float32)."""
    calc = _readme(torch.float64)
    assert calc.relres is None and calc.iters is None
    assert calc.matrix.shape == (2, 36, 2, 36)
    u = complex(calc.uscat(torch.zeros(3, 1, **F64))[0])
    assert (round(u.real, 6), round(u.imag, 6)) == (-0.741333, -0.669657)
    u32 = complex(_readme(torch.float32).uscat(torch.zeros(3, 1))[0])
    assert abs(u32 - u) <= 1e-4 * abs(u)


def _robin_lattice(solver, **kw):
    """test_biem.py::test_matfree_gmres_matches_direct's 2x2 lattice under
    a Robin condition, through the port."""
    k = torch.tensor(1.3, **F64)
    uin, uin_grad = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **F64))
    return biem(create_from_branching_types("ba"), centers=torch.tensor(_lattice(2)),
                radii=torch.ones(4, **F64), k=k, n_end=8, uin=uin, uin_grad=uin_grad,
                alpha=1.0, beta=0.5, eta=1.0, solver=solver, **kw)


def _robin_lattice_jax():
    """The JAX package's direct solve of `_robin_lattice` (density)."""
    uin, uin_grad = j_plane_wave(k=np.asarray(1.3), direction=np.array([1.0, 0.0, 0.0]))
    return tonp(j_biem(j_tree("ba"), centers=_lattice(2), radii=np.ones(4), k=np.asarray(1.3),
                       n_end=8, uin=uin, uin_grad=uin_grad, alpha=1.0, beta=0.5, eta=1.0,
                       solver="direct").density)


def test_direct_matches_matfree_and_dense_gmres(jax_values):
    d_lu = _robin_lattice("direct")
    d_mf = _robin_lattice("matfree", stable=True)
    d_gm = _robin_lattice("gmres")
    assert d_mf.matrix is None and d_lu.relres is None
    assert float(d_gm.relres) <= 1e-11 and int(d_gm.iters) > 0
    ref = d_lu.density.numpy()
    for calc in (d_mf, d_gm):
        assert np.abs(calc.density.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    # and the JAX package's direct solve (committed: `jax_golden`)
    j_ref = jax_values["robin lattice density"]
    assert np.abs(ref - j_ref).max() <= 1e-10 * np.abs(j_ref).max()


def _force_matrix_jax():
    centers, radii = _GEOMETRIES["random"]
    uin_j, _ = j_plane_wave(k=np.asarray(1.3), direction=np.array([0.0, 0.6, 0.8]))
    return j_biem(j_tree("ba"), centers=centers, radii=radii, k=np.asarray(1.3), n_end=6,
                  uin=uin_j, force_matrix=True)


def test_force_matrix_matches_jax(jax_values):
    """force_matrix on the default and the matfree solver: LU and dense
    GMRES on the assembled matrix, which matches the JAX package's
    (committed: `jax_golden`)."""
    centers, radii = _GEOMETRIES["random"]
    uin, _ = plane_wave(k=torch.tensor(1.3, **F64), direction=torch.tensor([0.0, 0.6, 0.8], **F64))
    for solver in ("auto", "matfree"):
        calc = biem(create_from_branching_types("ba"), centers=torch.tensor(centers),
                    radii=torch.tensor(radii), k=torch.tensor(1.3, **F64), n_end=6, uin=uin,
                    force_matrix=True, solver=solver)
        _assert_pair_blocks(calc.matrix.numpy(), jax_values["force_matrix matrix"])
        d_ref = jax_values["force_matrix density"]
        assert np.abs(calc.density.numpy() - d_ref).max() <= 1e-9 * np.abs(d_ref).max()
        assert (calc.relres is None) == (solver == "auto")


ONE_X = np.array([[2.0, 0.0], [1.0, -1.5], [0.5, 0.0]])


def _one_sphere_jax(stable):
    centers, radii = _GEOMETRIES["one"]
    uin_j, _ = j_plane_wave(k=KS, direction=np.broadcast_to([[1.0], [0.0], [0.0]], (3, 2)))
    return j_biem(j_tree("ba"), centers=np.broadcast_to(centers, (2, 1, 3)),
                  radii=np.broadcast_to(radii, (2, 1)), k=KS, n_end=6, uin=uin_j,
                  stable=stable)


@pytest.mark.parametrize("stable", [True, False])
def test_one_sphere_diagonal_solve_matches_jax(jax_values, stable):
    centers, radii = _GEOMETRIES["one"]
    uin, _ = plane_wave(k=torch.tensor(KS),
                        direction=torch.tensor([[1.0], [0.0], [0.0]]).expand(3, 2))
    calc = biem(create_from_branching_types("ba"),
                centers=torch.tensor(np.broadcast_to(centers, (2, 1, 3)).copy()),
                radii=torch.tensor(np.broadcast_to(radii, (2, 1)).copy()),
                k=torch.tensor(KS), n_end=6, uin=uin, stable=stable)
    assert calc.matrix is None and calc.relres is None
    np.testing.assert_allclose(calc.density.numpy(), jax_values[f"one sphere density {stable}"],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(calc.uscat(torch.tensor(ONE_X)).numpy(),
                               jax_values[f"one sphere uscat {stable}"], rtol=1e-11)


# (solver, B, n_end, real dtype, device, right-hand side, force_matrix,
# geometry, route), by the JAX package's thresholds (biem/_core.py: LU up to
# 6144 unknowns on an accelerator and 12288 on the CPU, the dense matrix up
# to 6 GB / 40 GB, matrix-free for dedup-rich 8 <= B < 64 beyond the LU tier,
# the lattice form from B = 64)
_ROUTE_CASES = [
    ("auto", 2, 6, "f64", "cpu", True, False, "line", "lu"),
    ("auto", 1, 6, "f64", "cpu", True, False, "line", "diagonal"),
    ("auto", 1, 6, "f64", "cpu", True, True, "line", "lu"),
    ("auto", 1, 6, "f64", "cpu", False, False, "line", "matrix"),
    ("auto", 2, 6, "f64", "cpu", False, False, "line", "matrix"),
    ("auto", 16, 19, "f32", "cuda", True, False, "lattice", "lu"),
    ("auto", 16, 32, "f32", "cuda", True, False, "lattice", "matfree"),
    ("auto", 16, 27, "f32", "cpu", True, False, "lattice", "lu"),
    ("auto", 16, 32, "f32", "cpu", True, False, "lattice", "matfree"),
    ("auto", 16, 32, "f32", "cuda", True, False, "random", "gmres"),
    ("auto", 16, 32, "f64", "cuda", True, False, "lattice", "matfree"),
    ("auto", 16, 32, "f64", "cpu", True, False, "lattice", "matfree"),
    ("auto", 16, 32, "f64", "cuda", True, False, "random", "gmres"),
    ("auto", 16, 40, "f64", "cuda", True, False, "random", "matfree"),
    ("auto", 16, 64, "f32", "cuda", True, False, "random", "matfree"),
    ("auto", 16, 64, "f32", "cpu", True, False, "random", "gmres"),
    ("auto", 4, 40, "f32", "cuda", True, False, "line", "gmres"),
    ("auto", 64, 4, "f64", "cpu", True, False, "lattice", "lattice"),
    ("auto", 64, 4, "f64", "cpu", True, True, "lattice", "lu"),
    ("auto", 16, 32, "f32", "cuda", True, True, "lattice", "gmres"),
    ("direct", 16, 32, "f32", "cuda", True, False, "lattice", "lu"),
    ("direct", 64, 4, "f64", "cpu", True, False, "lattice", "lu"),
    ("gmres", 2, 6, "f64", "cpu", True, False, "line", "gmres"),
    ("matfree", 2, 6, "f64", "cpu", True, False, "line", "matfree"),
    ("matfree", 1, 6, "f64", "cpu", True, False, "line", "diagonal"),
    ("matfree", 2, 6, "f64", "cpu", True, True, "line", "gmres"),
    ("matfree", 2, 6, "f64", "cpu", False, False, "line", "matrix"),
    ("matfree", 64, 4, "f64", "cpu", True, False, "lattice", "lattice"),
    # 64 spheres or more off a lattice take the routes of fewer
    ("auto", 64, 4, "f64", "cpu", True, False, "random", "lu"),
    ("matfree", 64, 4, "f64", "cpu", True, False, "random", "matfree"),
    ("auto", 64, 32, "f32", "cuda", True, False, "random", "matfree"),
    ("auto", 64, 12, "f32", "cuda", True, False, "random", "gmres"),
]


@pytest.mark.parametrize("case", _ROUTE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_route_chooser_keeps_the_jax_thresholds(case):
    solver, n_b, n_end, rdt, dev, has_rhs, force, geometry, route = case
    if geometry == "lattice":
        centers = _lattice(int(round(np.sqrt(n_b))))
    elif geometry == "random":
        centers = np.random.default_rng(16).normal(size=(n_b, 3)) * 10.0
    else:
        centers = np.stack([3.0 * np.arange(n_b), np.zeros(n_b), np.zeros(n_b)], axis=1)
    n_sys = n_b * n_end * n_end
    got = _core._route(solver, n_b, n_sys, {"f32": torch.float32, "f64": torch.float64}[rdt],
                       torch.device(dev), has_rhs, force, centers)
    assert got == route


def test_stable_dense_float32_past_the_overflow_wall():
    """Two unit spheres at t = 4, k = 1, n_end = 24: the unscaled float32
    matrix overflows there (|h_42(4)| > 3.4e38); the stable dense LU stays
    finite and within 1e-3 of float64."""
    c32 = _readme(torch.float32, solver="direct")
    assert bool(torch.isfinite(c32.matrix).all())
    f32 = dict(dtype=torch.float32)
    calc32 = biem(create_from_branching_types("ba"),
                  centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f32),
                  radii=torch.ones(2, **f32), k=torch.tensor(1.0, **f32), n_end=24,
                  uin=plane_wave(k=torch.tensor(1.0, **f32),
                                 direction=torch.tensor([1.0, 0.0, 0.0], **f32))[0])
    assert calc32.relres is None and bool(torch.isfinite(calc32.density).all())
    uin, _ = plane_wave(k=torch.tensor(1.0, **F64), direction=torch.tensor([1.0, 0.0, 0.0]))
    calc64 = biem(create_from_branching_types("ba"),
                  centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **F64),
                  radii=torch.ones(2, **F64), k=torch.tensor(1.0, **F64), n_end=24, uin=uin)
    d32, d64 = calc32.density.to(torch.complex128), calc64.density
    assert float((d32 - d64).abs().max()) <= 1e-3 * float(d64.abs().max())
    u32 = complex(calc32.uscat(torch.zeros(3, 1, **f32))[0])
    u64 = complex(calc64.uscat(torch.zeros(3, 1, **F64))[0])
    assert abs(u32 - u64) <= 1e-3 * abs(u64)
    plain = biem(create_from_branching_types("ba"),
                 centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f32),
                 radii=torch.ones(2, **f32), k=torch.tensor(1.0, **f32), n_end=24,
                 stable=False)
    assert not bool(torch.isfinite(plain.matrix).all())  # the wall the stable route avoids


def test_translational_coefficients_method_keyword():
    """Accepted and validated as translation_matrix does; "rotation" is
    the default's algorithm on the plain dense route; the scale-compensated
    routes ignore it."""
    ref = complex(_readme(torch.float64).uscat(torch.zeros(3, 1, **F64))[0])
    for kw in (dict(translational_coefficients_method="rotation"),
               dict(translational_coefficients_method="triplet", stable=True),
               dict(translational_coefficients_method="gumerov", solver="matfree",
                    stable=True)):
        u = complex(_readme(torch.float64, **kw).uscat(torch.zeros(3, 1, **F64))[0])
        assert abs(u - ref) <= 1e-9, kw
    with pytest.raises(ValueError, match="plane_wave"):
        _readme(torch.float64, translational_coefficients_method="plane_wave")
    with pytest.raises(ValueError, match="unknown translation method"):
        _readme(torch.float64, translational_coefficients_method="bogus", stable=True)


def test_kernel_launch_rejects_operands_on_two_devices():
    """kernels.launch takes its device from the operands and refuses
    operands that lie on different devices (or off the card) before it
    loads anything."""
    with pytest.raises(RuntimeError, match="different devices"):
        kernels.launch("bhs_dense_assemble", torch.zeros(1), torch.zeros(1, device="meta"), 3)
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.launch("bhs_dense_assemble", torch.zeros(1), 3)
