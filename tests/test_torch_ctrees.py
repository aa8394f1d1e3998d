"""Trees with a 'c' node ('caa', 'bcaa', 'cbaba') in the port, against
the JAX package on the CPU in float64, on the same numpy inputs.

* `harmonics` of the 'c' node (1e-12) and the orthonormality of the basis
  under the tree's quadrature;
* `translation_matrix` on 'caa': the band-scan (S|R) by default, with
  "triplet" and with n_end_add != n_end, and the plane-wave (R|R) (1e-12
  of each degree block's largest entry);
* `biem()` on the 'caa' pair on every route the JAX package opens to it
  (LU, dense GMRES, the offset table scaled and unscaled), the 8 x 8 'caa'
  lattice on the lattice route, 'bcaa' on the factored and the dense
  route, 'cbaba' by LU, against the JAX package's golden solves committed
  in data/caa4d_golden_f64.json (`python tools/torch_golden_from_jax.py
  --caa`; densities within 1e-9: the GMRES routes stop at their float64
  tolerance 1e-11) and the reference's 'caa' golden value (2e-6);
* the quadrature right-hand side (`point_source`, stripped plane waves),
  `uscat` near, far and per ball through the general evaluation, and
  `max_memory` / `max_n_end` in 4 and 6 dimensions.

The JAX band scan compiles for minutes per shape on the CPU, and the JAX
general evaluation for two: the translations and the fields are held to
the JAX package's values committed in tests/golden/test_torch_ctrees.npz
(`jax_golden` below, `python tools/torch_golden_from_jax.py --tests`),
every solve to the committed golden.
"""

import json
from pathlib import Path

import _jax_golden
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import harmonics as j_harmonics
from biem_helmholtz_sphere_tpu import max_memory as j_max_memory
from biem_helmholtz_sphere_tpu import max_n_end as j_max_n_end
from biem_helmholtz_sphere_tpu.biem._core import BIEMResultCalculator as JResult
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation import translation_matrix as j_translation_matrix
from biem_helmholtz_sphere_tpu_torch import (
    biem,
    max_memory,
    max_n_end,
    plane_wave,
    point_source,
)
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types, from_cartesian
from biem_helmholtz_sphere_tpu_torch.harmonics import basis, harmonics, sphere_quadrature
from biem_helmholtz_sphere_tpu_torch.translation import translation_matrix
from biem_helmholtz_sphere_tpu_torch.translation._ops import _sr_banded

F64 = dict(dtype=torch.float64)
GOLDEN_CAA = -0.454651 - 0.423387j  # tests/test_biem.py (jascome_output_4d.csv)
DATA = Path(__file__).resolve().parent.parent / "biem_helmholtz_sphere_tpu_torch" / "data"
ROUTES = {
    "lu": {},
    "gmres": dict(solver="gmres"),
    "offset-table-scaled": dict(solver="matfree", stable=True),
    "offset-table": dict(solver="matfree", stable=False),
}


TRANSLATIONS = [
    ("SR", None, None), ("SR", None, "triplet"), ("SR", 5, None), ("RR", None, None),
    ("RR", 5, "plane_wave"),
]


def _caa_offsets():
    t = np.random.default_rng(8).normal(size=(4, 3))
    return t * 3.7 / np.linalg.norm(t, axis=0), np.array([[1.3], [0.8]])


def _field_points():
    """(near, far) evaluation points of the 'caa' pair's field."""
    rng = np.random.default_rng(6)
    near = rng.normal(size=(4, 3)) * 2.0
    near[0] += 4.0
    far = rng.normal(size=(4, 2))
    far /= np.linalg.norm(far, axis=0)
    return near, far


def _field_calls():
    near, far = _field_points()
    return {"near": (near, {}), "far": (far, dict(far_field=True)),
            "per_ball": (near[:, :2], dict(per_ball=True))}


def jax_golden():
    """The JAX package's values the tests below read: `translation_matrix`
    on 'caa' for each case of TRANSLATIONS, and the fields of its own
    density of the 'caa' pair (data/caa4d_golden_f64.json)."""
    t, k = _caa_offsets()
    out = {}
    for kind, n_add, method in TRANSLATIONS:
        out[f"translation {kind}-{n_add}-{method}"] = tonp(j_translation_matrix(
            j_tree("caa"), jnp.asarray(t), 4, jnp.asarray(k), kind=kind, n_end_add=n_add,
            method=method))
    rows = json.loads((DATA / "caa4d_golden_f64.json").read_text())["points"]
    row = next(r for r in rows if r["name"] == "pair caa")
    density = (np.array(row["density"][0]) + 1j * np.array(row["density"][1])).reshape(
        row["density_shape"])
    jcalc = JResult(centers=jnp.asarray(_pair(4)), radii=jnp.ones(2), k=jnp.asarray(1.0),
                    eta=jnp.asarray(1.0), density=C.of(density), matrix=None,
                    c=j_tree("caa"), n_end=6)
    for name, (x, kw) in _field_calls().items():
        out[f"field {name}"] = tonp(jcalc.uscat(jnp.asarray(x), **kw))
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_ctrees")


@pytest.fixture(scope="module")
def golden():
    """The JAX package's solves of the 'c'-node anchors, by name."""
    rows = json.loads((DATA / "caa4d_golden_f64.json").read_text())["points"]
    out = {}
    for row in rows:
        if "density" in row:
            re, im = row["density"]
            row["density"] = (np.array(re) + 1j * np.array(im)).reshape(row["density_shape"])
        row["uscat0"] = complex(*row["uscat0"])
        out.setdefault(row["name"], []).append(row)
    return out


def _x0(d):
    v = np.zeros(d)
    v[0] = 1.0
    return v


def _pair(d):
    centers = np.zeros((2, d))
    centers[0, 1], centers[1, 1] = 2.0, -2.0
    return centers


def _lattice(n_side, d, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0], centers[:, 1] = xx.ravel(), yy.ravel()
    return centers


def _solve(tree, centers, n_end, k=1.0, rdt=torch.float64, uin=None, **kw):
    c = create_from_branching_types(tree)
    f = dict(dtype=rdt)
    kt = torch.tensor(k, **f)
    if uin is None:
        uin, _ = plane_wave(k=kt, direction=torch.tensor(_x0(c.c_ndim), **f))
    return biem(c, centers=torch.tensor(centers, **f), radii=torch.ones(len(centers), **f),
                k=kt, n_end=n_end, uin=uin, **kw)


def _uscat0(calc):
    d = calc.c.c_ndim
    return complex(calc.uscat(torch.zeros(d, 1, dtype=calc.radii.dtype)).reshape(-1)[0])


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _block_rel(got, ref, n_o, n_i):
    err = 0.0
    for a in np.unique(n_o):
        for b in np.unique(n_i):
            g, r = got[..., n_o == a, :][..., n_i == b], ref[..., n_o == a, :][..., n_i == b]
            d = np.abs(g - r).max(axis=(-2, -1))
            err = max(err, float((d / np.abs(r).max(axis=(-2, -1))).max()))
    return err


@pytest.mark.parametrize("tree,n_end", [("caa", 5), ("bcaa", 4), ("cbaba", 4)])
def test_c_node_harmonics_match_jax(tree, n_end):
    """The 'c' node's Jacobi table in cos 2 theta against the JAX package at
    random points (1e-12), and the basis orthonormal under the tree's
    quadrature (1e-12)."""
    c, cj = create_from_branching_types(tree), j_tree(tree)
    x = np.random.default_rng(4).normal(size=(c.c_ndim, 23))
    got = harmonics(c, from_cartesian(c, torch.tensor(x)), n_end).numpy()
    ref = tonp(j_harmonics.harmonics(cj, j_from_cartesian(cj, jnp.asarray(x)), n_end))
    assert got.shape == ref.shape == (23, basis(c, n_end).num)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    sph, w = sphere_quadrature(c, 2 * (n_end - 1))
    y = harmonics(c, {key: torch.tensor(v) for key, v in sph.items()}, n_end).numpy()
    gram = (y.conj().T * w) @ y
    assert np.abs(gram - np.eye(len(gram))).max() < 1e-12


@pytest.mark.parametrize("kind,n_add,method", TRANSLATIONS)
def test_caa_translation_matches_jax(jax_values, kind, n_add, method):
    """translation_matrix on 'caa' at n_end=4, three offsets x two k: the
    band scan (the default and "triplet" on a 'c' root; n_end_add != n_end)
    and the plane-wave (R|R), 1e-12 of each degree block's largest entry
    of the JAX package's (committed: `jax_golden`)."""
    t, k = _caa_offsets()
    ref = jax_values[f"translation {kind}-{n_add}-{method}"]
    c = create_from_branching_types("caa")
    got = translation_matrix(c, torch.tensor(t), 4, torch.tensor(k), kind=kind,
                             n_end_add=n_add, method=method).numpy()
    h_in = basis(c, n_add or 4).num
    assert got.shape == ref.shape == (2, 3, 30, h_in)
    assert _block_rel(got, ref, basis(c, 4).n_root, basis(c, n_add or 4).n_root) < 1e-12


def test_caa_pair_takes_the_offset_table_when_matrix_free():
    """solver="matfree", stable=True on a 'c' root builds the scale-
    compensated offset table (KS's fold mode), never the factored
    operator, as the JAX package's dispatch."""
    called = []
    orig = _core._factored_operator
    try:
        _core._factored_operator = lambda *a, **kw: called.append(1) or orig(*a, **kw)
        _solve("caa", _pair(4), 4, solver="matfree", stable=True)
    finally:
        _core._factored_operator = orig
    assert not called


def test_bcaa_rotation_equals_the_band_scan():
    """The JAX package's tests/test_rotation_translation.py case ("bcaa",
    4): the rotation + coaxial (S|R) equals the band scan's ("triplet"),
    1e-10 of each degree block's largest entry; and the rotation (R|R)
    equals the band scan with j bands (`_sr_banded`: a "triplet" (R|R)
    takes the plane-wave kernel, in the JAX package too, whose quadrature
    aliases the bands above its exactness)."""
    c = create_from_branching_types("bcaa")
    t = torch.tensor(np.random.default_rng(2).normal(size=(5, 3)) * 1.8)
    k = torch.tensor([[1.1], [0.7]], **F64)
    n_root = basis(c, 4).n_root
    rot = translation_matrix(c, t, 4, k, method="rotation").numpy()
    band = translation_matrix(c, t, 4, k, method="triplet").numpy()
    assert _block_rel(band, rot, n_root, n_root) < 1e-10
    rot = translation_matrix(c, t, 4, k, kind="RR", method="rotation").numpy()
    band = _sr_banded(c, None, t, 4, 4, k, "RR").numpy()
    assert _block_rel(band, rot, n_root, n_root) < 1e-10


def test_caa_fields_match_jax(jax_values):
    """uscat near, far and per ball on 'caa' (the general evaluation)
    against the JAX package's evaluation of its own density (1e-9;
    committed: `jax_golden`)."""
    calc = _solve("caa", _pair(4), 6)
    for name, (x, kw) in _field_calls().items():
        got = calc.uscat(torch.tensor(x), **kw).numpy()
        want = jax_values[f"field {name}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-9, kw


@pytest.mark.parametrize("field", ["point-source", "stripped-plane-wave"])
def test_caa_quadrature_rhs(field):
    """Any incident field but a plane wave's closures takes the quadrature
    right-hand side: a point source off the spheres on LU and on the
    offset table (agreeing to 1e-9, sound-soft boundary residual small),
    and the plane wave with its tags stripped against the closed form (the
    quadrature truncation, 1e-6)."""
    k = torch.tensor(1.2, **F64)
    if field == "point-source":
        uin, _ = point_source(k=k, source=torch.tensor([0.4, 0.3, 2.8, 0.1], **F64))
        lu = _solve("caa", _pair(4), 6, k=1.2, uin=uin)
        mf = _solve("caa", _pair(4), 6, k=1.2, uin=uin, solver="matfree")
        assert _rel(mf.density.numpy(), lu.density.numpy()) <= 1e-9
        # the boundary condition u_in + u_scat = 0 on sphere 0
        pts = np.random.default_rng(1).normal(size=(4, 16))
        pts = pts * (1.0 + 1e-9) / np.linalg.norm(pts, axis=0) + _pair(4)[0][:, None]
        x = torch.tensor(pts)
        resid = (lu.uscat(x) + uin(x)).abs().max() / uin(x).abs().max()
        assert float(resid) < 1e-3
        return
    pw, _ = plane_wave(k=k, direction=torch.tensor(_x0(4)))
    closed = _solve("caa", _pair(4), 6, k=1.2, uin=pw)
    quad = _solve("caa", _pair(4), 6, k=1.2, uin=lambda x, /: pw(x))
    assert _rel(quad.density.numpy(), closed.density.numpy()) <= 1e-6


@pytest.mark.parametrize("d,n_end,n_balls", [(4, 6, 2), (4, 14, 16), (6, 3, 2)])
def test_memory_model_matches_jax_for_c_trees(d, n_end, n_balls):
    assert max_memory(c_ndim=d, n_end=n_end, n_balls=n_balls) == j_max_memory(
        c_ndim=d, n_end=n_end, n_balls=n_balls)
    for limit in (10**6, 10**9):
        assert max_n_end(c_ndim=d, memory_limit=limit, n_balls=n_balls) == j_max_n_end(
            c_ndim=d, memory_limit=limit, n_balls=n_balls)
