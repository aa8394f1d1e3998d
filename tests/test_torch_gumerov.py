"""The Gumerov-Duraiswami translation (method="gumerov") against the JAX
package on the CPU, from the same seeded numpy inputs.

Tolerances.  The coaxial factor is held per (l', l) degree block, relative
to the block's own largest entry (a bound relative to the whole matrix
would pass a spoiled small high-degree block): 1e-12 in float64, where
both packages run the same ladders on radial columns that agree to
~1e-15; 2e-4 in float32, where the columns (each package's float32
recurrences) differ by a few ulps and the n-advance ladder magnifies that
in the small blocks far from the diagonal (the largest seen here is
~3e-5).  Solves meet the float64 GMRES tolerance 1e-11 (or are direct),
so densities agree within 1e-9 of the largest entry.  The JAX package's
solves are committed in tests/golden/test_torch_gumerov.npz (`jax_golden`,
`python tools/torch_golden_from_jax.py --tests`); its translations are
called live.
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation import gd_coaxial as j_gd_coaxial
from biem_helmholtz_sphere_tpu.translation import sr_gumerov as j_sr_gumerov
from biem_helmholtz_sphere_tpu.translation import translation_matrix as j_translation_matrix
from biem_helmholtz_sphere_tpu_torch import biem
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types, from_cartesian
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.translation import (
    coaxial_sr,
    gd_coaxial,
    sr_gumerov,
    translation_matrix,
)

F64 = dict(dtype=torch.float64)
RTOL = {np.float64: 1e-12, np.float32: 2e-4}
# The (R|R) ladder forms its small blocks (|j_{l+l'}(kr)| at small kr, down
# to 1e-6 of the matrix here) by cancellation from entries the size of the
# largest: both packages' ladders, and their band sums, differ there by up
# to ~1e-10 of such a block (2.5e-9 between the JAX package's own two
# algorithms at kr = 2.6), ~6e-16 of the matrix.  Such blocks are held
# against 1e-3 of the matrix's largest entry.
RR_FLOOR = 1e-3
# distances of the bench's lattice (4, 4 sqrt 2, 8, 12 sqrt 2) and closer
RADII = np.array([2.0, 4.0, 4.0 * np.sqrt(2.0), 8.0, 12.0 * np.sqrt(2.0)])


def _jk(k):
    """k for the JAX package: a real array, or its complex pair type."""
    k = np.asarray(k)
    return C(k.real, k.imag) if np.iscomplexobj(k) else k


def _block_errors(got, ref, ell, floor=0.0):
    """The largest |got - ref| of each (l', l) degree block over the
    largest |ref| of that block (per leading batch entry), as one array;
    a block below `floor` times its matrix's largest entry is held
    against that instead."""
    out = []
    big = floor * np.abs(ref).max(axis=(-2, -1))
    for lr in np.unique(ell):
        for lc in np.unique(ell):
            g = got[..., ell == lr, :][..., ell == lc]
            r = ref[..., ell == lr, :][..., ell == lc]
            scale = np.maximum(np.abs(r).max(axis=(-2, -1)), big)
            out.append(np.abs(g - r).max(axis=(-2, -1)) / np.where(scale > 0, scale, 1.0))
    return np.stack(out)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [1.3, 1.3 + 0.2j], ids=["real-k", "complex-k"])
@pytest.mark.parametrize("kind", ["SR", "RR"])
def test_gd_coaxial_matches_jax(kind, k, dtype):
    """gd_coaxial at n_end = 12 over five radii, per degree block."""
    c = create_from_branching_types("ba")
    n_end = 12
    r = RADII.astype(dtype)
    kk = np.asarray(k, dtype=np.result_type(dtype, np.asarray(k).dtype))
    got = gd_coaxial(c, torch.tensor(r), n_end, torch.tensor(kk), kind=kind).numpy()
    ref = tonp(j_gd_coaxial(j_tree("ba"), r, n_end, _jk(kk), kind=kind))
    h = basis(c, n_end).num
    assert got.shape == ref.shape == (len(r), h, h)
    assert got.dtype == (np.complex128 if dtype == np.float64 else np.complex64)
    assert np.isfinite(got).all()
    floor = RR_FLOOR if kind == "RR" else 0.0
    assert _block_errors(got, ref, basis(c, n_end).n_root, floor).max() <= RTOL[dtype]


def test_gd_coaxial_equals_the_band_sum():
    """The ladders and the rotation route's band sum (`coaxial_sr`) are two
    algorithms for one matrix: 1e-11 per degree block in float64."""
    c = create_from_branching_types("bpa")
    r, k = torch.tensor(RADII), torch.tensor([[1.3], [2.1]], **F64)
    got = gd_coaxial(c, r, 8, k).numpy()
    ref = coaxial_sr(c, r, 8, k).numpy()
    assert _block_errors(got, ref, basis(c, 8).n_root).max() <= 1e-11


def test_sr_gumerov_matches_jax():
    """sr_gumerov at random offsets (n_end = 8), by their cartesian form and
    by their spherical mapping."""
    rng = np.random.default_rng(155)
    c, cj = create_from_branching_types("ba"), j_tree("ba")
    n_end = 8
    t = rng.normal(size=(3, 3))
    t *= 4.0 / np.linalg.norm(t, axis=0, keepdims=True)
    t_sph = from_cartesian(c, torch.tensor(t))
    got = sr_gumerov(c, t_sph, n_end, 1.3, t_cart=torch.tensor(t)).numpy()
    by_sph = sr_gumerov(c, t_sph, n_end, torch.tensor(1.3, **F64)).numpy()
    ref = tonp(j_sr_gumerov(cj, j_from_cartesian(cj, t), n_end, np.asarray(1.3), t_cart=t))
    assert got.shape == ref.shape == (3, 64, 64)
    ell = basis(c, n_end).n_root
    assert _block_errors(got, ref, ell).max() <= 1e-11
    assert _block_errors(by_sph, ref, ell).max() <= 1e-11


@pytest.mark.parametrize("btype", ["ba", "bpa"])
def test_translation_matrix_gumerov_matches_jax(btype):
    """translation_matrix(method="gumerov") over offsets x two k, with a
    repeated radius (the ladders run at the distinct radii only).

    The port's "gumerov" and default (rotation) tables share the masked
    degree-group sandwich and agree within 1e-13 per degree block.  The
    JAX package's "gumerov" takes a dense product with D instead: at the
    shortest offsets here (|t| = 1.28) the two sandwiches differ by up to
    ~3e-10 of a small high-degree block, as the JAX package's own rotation
    and band-scan ("triplet") tables do; so against it 1e-9 per block."""
    rng = np.random.default_rng(21)
    c = create_from_branching_types(btype)
    t = rng.normal(size=(3, 4)) * 3.0
    t = np.concatenate([t, -t[:, :1], 5.0 * np.eye(3)[:, -1:]], axis=1)
    k = torch.tensor([[1.3], [2.1]], **F64)
    got = translation_matrix(c, torch.tensor(t), 6, k, method="gumerov").numpy()
    rot = translation_matrix(c, torch.tensor(t), 6, k, method="rotation").numpy()
    ref = tonp(j_translation_matrix(j_tree(btype), t, 6, k.numpy(), method="gumerov"))
    assert got.shape == ref.shape == (2, 6, 36, 36)
    ell = basis(c, 6).n_root
    assert _block_errors(got, rot, ell).max() <= 1e-13
    assert _block_errors(got, ref, ell).max() <= 1e-9


@pytest.mark.parametrize("case", ["a", "caa", "bba", "n_end_add"])
def test_gumerov_raises_where_jax_does(case):
    """ValueError on every tree but "ba"/"bpa" and on n_end_add != n_end,
    from translation_matrix and from a plain biem() route, as the JAX
    package raises."""
    btype = "ba" if case == "n_end_add" else case
    c, cj = create_from_branching_types(btype), j_tree(btype)
    t = np.full((c.c_ndim, 1), 2.0)
    kw = dict(method="gumerov", n_end_add=3 if case == "n_end_add" else None)
    with pytest.raises(ValueError) as jax_err:
        j_translation_matrix(cj, t, 4, np.array([1.0]), **kw)
    with pytest.raises(ValueError) as port_err:
        translation_matrix(c, torch.tensor(t), 4, torch.tensor([1.0], **F64), **kw)
    assert str(port_err.value) == str(jax_err.value)
    if case == "n_end_add":
        return
    centers = torch.zeros(2, c.c_ndim, **F64)
    centers[:, 0] = torch.tensor([-1.5, 1.5])
    with pytest.raises(ValueError, match="gumerov"):
        biem(c, centers=centers, radii=torch.ones(2, **F64), k=torch.tensor(1.0, **F64),
             n_end=3, solver="direct", stable=False, translational_coefficients_method="gumerov")


def _lattice(n_side, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _line(n, spacing=3.0):
    centers = np.zeros((n, 3))
    centers[:, 0] = spacing * np.arange(n)
    return centers


# (solver, centers [..., B, 3], k [K], n_end, the route the port takes)
SOLVES = {
    "lu": ("direct", _lattice(2), np.array([1.3, 2.1]), 5, "lu"),
    "dense-gmres": ("gmres", _lattice(2), np.array([1.3, 2.1]), 5, "gmres"),
    "offset-table": ("matfree", _lattice(3), np.array([1.3]), 5, "matfree"),
    "lattice-64": ("matfree", _line(64), np.array([1.0]), 3, "lattice"),
    "complex-k": ("direct", _lattice(2), np.array([1.3 + 0.1j, 2.1 + 0.05j]), 5, "lu"),
    "per-k-geometry": ("direct", np.stack([_lattice(2, 3.0), _lattice(2, 4.5)]),
                       np.array([1.3, 2.1]), 5, "lu"),
}


def _solve_call(case):
    """(direction [3, K], biem() keywords as numpy) of a case of SOLVES."""
    solver, centers, k, n_end, _ = SOLVES[case]
    n_balls = centers.shape[-2]
    direction = np.broadcast_to(np.array([1.0, 0.0, 0.0])[:, None], (3, len(k))).copy()
    return direction, dict(
        centers=np.broadcast_to(centers, (len(k), n_balls, 3)).copy(), k=k,
        radii=np.ones((len(k), n_balls)), n_end=n_end, solver=solver, stable=False,
        translational_coefficients_method="gumerov")


def _overflow_call():
    """biem() keywords (numpy, float32) of the overflow pair."""
    return dict(centers=np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], np.float32),
                k=np.float32(1.0), radii=np.ones(2, np.float32), n_end=24, solver="direct",
                stable=False, translational_coefficients_method="gumerov")


def jax_golden():
    """The JAX package's solves that the tests below read (each compiles
    for 10 s to 1.5 minutes on a cold CPU): every case of SOLVES, and the
    float32 overflow pair's density with its matrix's finite entries."""
    out = {}
    for case in SOLVES:
        direction, call = _solve_call(case)
        j_uin, _ = j_plane_wave(k=_jk(call["k"]), direction=direction)
        out[f"solve {case}"] = j_biem(j_tree("ba"), uin=j_uin,
                                      **{**call, "k": _jk(call["k"])}).density.to_numpy()
    j_uin, _ = j_plane_wave(k=np.float32(1.0), direction=np.array([1.0, 0.0, 0.0], np.float32))
    calc = j_biem(j_tree("ba"), uin=j_uin, **_overflow_call())
    out["overflow density"] = calc.density.to_numpy()
    out["overflow matrix finite"] = np.isfinite(calc.matrix.to_numpy())
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_gumerov")


def _port(call, uin):
    return biem(create_from_branching_types("ba"), uin=uin,
                **{key: torch.tensor(v) if isinstance(v, (np.ndarray, np.generic)) else v
                   for key, v in call.items()})
