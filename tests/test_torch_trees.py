"""'bp'-rooted 3D trees, the general field evaluation, and geometry that
varies along the batch, through the port against the JAX package on the
CPU in float64 from the same numpy inputs.

* 'bpa' (the 3D tree rooted at a 'bp' node): the README golden on every
  route (2e-6, the JAX package's tests/test_biem.py tolerance), and JAX
  parity of the density and of uscat at points, the far field and
  per_ball on the default route and the factored route, against the JAX
  package's dense GMRES (1e-8: it stops at the float64 GMRES tolerance).
* The general evaluation (`harmonic_sum`, every tree but "ba") forced on
  "ba" against KA's plain version: the same sum in another order (1e-12
  of the largest value).
* Geometry along the batch: the README pair and the same pair x 1.5 at
  k = 1.0 and 1.1, on the dense routes the JAX package takes for it (no
  matrix-free route); uscat and calc.matrix against the JAX package
  (1e-10), and a batch with the geometry along one axis and k along the
  other against each member solved alone.

The JAX package's solves are committed in tests/golden/test_torch_trees.npz
(`jax_golden`, `python tools/torch_golden_from_jax.py --tests`).
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import BIEMResultCalculator, biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.biem._eval import harmonic_sum
from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import _fused_ba_eval_plain, regroup
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, _pair_order

N_END = 6
CENTERS = np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
DIRECTION = np.array([1.0, 0.0, 0.0])
GOLDEN = -0.741333 - 0.669657j
F64 = dict(dtype=torch.float64)
ROUTES = {
    "lu": {},
    "gmres": dict(solver="gmres"),
    "factored": dict(solver="matfree", stable=True),
    "offset-table": dict(solver="matfree", stable=False),
    "force-matrix": dict(force_matrix=True),
}
X_NEAR = np.array([[3.0, -1.0, 0.5, 0.1], [0.5, 4.0, -3.5, 2.2], [-2.0, 1.0, 0.3, 0.0]])
X_FAR = np.array([[1.0, 0.0, 0.6], [0.0, 0.6, 0.0], [0.0, 0.8, 0.8]])


def _assert_close(got, ref, tol):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=tol * np.abs(ref[~nan]).max())


def _fields(calc, lib):
    """(near field, far field, per_ball) as numpy."""
    if lib == "jax":
        return (tonp(calc.uscat(X_NEAR)), tonp(calc.uscat(X_FAR, far_field=True)),
                tonp(calc.uscat(X_NEAR[:, :2], per_ball=True)))
    return (calc.uscat(torch.tensor(X_NEAR)).numpy(),
            calc.uscat(torch.tensor(X_FAR), far_field=True).numpy(),
            calc.uscat(torch.tensor(X_NEAR[:, :2]), per_ball=True).numpy())


def _readme(btype, **kw):
    uin, _ = plane_wave(k=torch.tensor(1.0, **F64), direction=torch.tensor(DIRECTION))
    return biem(create_from_branching_types(btype), centers=torch.tensor(CENTERS),
                radii=torch.ones(2, **F64), k=torch.tensor(1.0, **F64), n_end=N_END, uin=uin,
                **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_bpa_readme_golden_on_every_route(route):
    calc = _readme("bpa", **ROUTES[route])
    assert (calc.relres is None) == (route in ("lu", "force-matrix"))
    u = complex(calc.uscat(torch.zeros(3, 1, **F64))[0])
    assert abs(u - GOLDEN) <= 2e-6


def jax_golden():
    """The JAX package's solves the fixtures below read (each half a minute
    to a minute of compile on a cold CPU): 'bpa' by dense GMRES, and the
    geometry batch with force_matrix."""
    uin, _ = j_plane_wave(k=np.asarray(1.0), direction=DIRECTION)
    calc = j_biem(j_tree("bpa"), centers=CENTERS, radii=np.ones(2), k=np.asarray(1.0),
                  n_end=N_END, uin=uin, solver="gmres")
    out = {f"bpa field {i}": v for i, v in enumerate(_fields(calc, "jax"))}
    out["bpa density"] = tonp(calc.density)
    uin, _ = j_plane_wave(k=BATCH_KS, direction=np.broadcast_to(DIRECTION[:, None], (3, 2)))
    calc = j_biem(j_tree("ba"), centers=BATCH_CENTERS, radii=np.ones((2, 2)), k=BATCH_KS,
                  n_end=N_END, uin=uin, force_matrix=True)
    out["batch uscat0"] = tonp(calc.uscat(np.zeros((3, 1))))[0]
    out.update({f"batch field {i}": v for i, v in enumerate(_fields(calc, "jax"))})
    out["batch matrix"] = tonp(calc.matrix)
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_trees")


def _fields_of(jax_values, name):
    return tuple(jax_values[f"{name} field {i}"]
                 for i in range(sum(k.startswith(f"{name} field ") for k in jax_values)))


@pytest.fixture(scope="module")
def jax_bpa(jax_values):
    """The JAX package's 'bpa' dense GMRES solve: (fields, density),
    committed (`jax_golden`)."""
    return _fields_of(jax_values, "bpa"), jax_values["bpa density"]


@pytest.mark.parametrize("route,tol", [("lu", 1e-8), ("factored", 1e-8)])
def test_bpa_fields_match_jax(jax_bpa, route, tol):
    """Against the JAX package's dense GMRES solve (its float64 tolerance
    bounds the agreement of any two routes at ~1e-9)."""
    fields, dens = jax_bpa
    calc = _readme("bpa", **ROUTES[route])
    _assert_close(calc.density.numpy(), dens, tol)
    for got, ref in zip(_fields(calc, "torch"), fields):
        assert got.shape == ref.shape
        _assert_close(got, ref, tol)


def test_bpa_and_ba_agree_off_the_chart():
    """The scattered field does not depend on the chart: 'bpa' and 'ba'
    give the same field at points and far directions (1e-10)."""
    for a, b in zip(_fields(_readme("bpa"), "torch"), _fields(_readme("ba"), "torch")):
        _assert_close(a, b, 1e-10)


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("per_ball", [False, True])
@pytest.mark.parametrize("complex_k", [False, True])
def test_general_evaluation_equals_ka_plain_on_ba(far, per_ball, complex_k):
    """harmonic_sum forced on "ba" against _fused_ba_eval_plain, with each
    k's own centers (two geometries) and points outside every sphere."""
    rng = np.random.default_rng(3)
    c = create_from_branching_types("ba")
    n_end, n_k = 7, 2
    k = torch.tensor([1.1 + 0.2j, 2.0 + 0.1j] if complex_k else [1.1, 2.0])
    centers = torch.tensor(np.stack([CENTERS * 1.5, CENTERS[::-1] + 0.3]))
    h = n_end * n_end
    w = torch.tensor((rng.normal(size=(n_k, 2, h)) + 1j * rng.normal(size=(n_k, 2, h)))
                     * np.exp(-np.arange(h) / 6.0))
    x = torch.tensor(rng.normal(size=(3, 1, 9)) * 2.0 + np.array([8.0, 0.0, 0.0])[:, None, None])
    if far:
        x = x / torch.linalg.vector_norm(x, dim=0)
    got = harmonic_sum(c, n_end, x, centers, k, w, far=far, per_ball=per_ball).numpy()
    ref = _fused_ba_eval_plain(x, centers, k, regroup(c, n_end, w), far, per_ball).numpy()
    assert got.shape == ref.shape == ((9, n_k, 2) if per_ball else (9, n_k))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


BATCH_CENTERS = np.stack([CENTERS, 1.5 * CENTERS])  # [2, B, 3]
BATCH_KS = np.array([1.0, 1.1])


@pytest.fixture(scope="module")
def jax_batch(jax_values):
    """The JAX package's geometry batch with force_matrix: (uscat(0),
    fields, matrix), committed (`jax_golden`)."""
    return (jax_values["batch uscat0"], _fields_of(jax_values, "batch"),
            jax_values["batch matrix"])


def _port_batch(**kw):
    uin, _ = plane_wave(k=torch.tensor(BATCH_KS),
                        direction=torch.tensor(np.broadcast_to(DIRECTION[:, None], (3, 2)).copy()))
    return biem(create_from_branching_types("ba"), centers=torch.tensor(BATCH_CENTERS),
                radii=torch.ones(2, 2, **F64), k=torch.tensor(BATCH_KS), n_end=N_END, uin=uin,
                **kw)


@pytest.mark.parametrize("route", ["lu", "gmres", "stable", "matfree"])
def test_batch_geometry_matches_jax(jax_batch, route):
    kw = {"gmres": dict(solver="gmres"), "stable": dict(stable=True),
          "matfree": dict(solver="matfree")}.get(route, {})
    calc = _port_batch(**kw)
    # never matrix-free: "matfree" takes the dense GMRES, as the JAX package
    assert calc.matrix is not None
    assert (calc.relres is None) == (route in ("lu", "stable"))
    tol = 1e-10 if calc.relres is None else 1e-8
    u0, fields, matrix = jax_batch
    got = calc.uscat(torch.zeros(3, 1, **F64))[0].numpy()
    np.testing.assert_allclose(got, [-0.74133302 - 0.66965742j, 0.3555168 - 0.43833321j],
                               atol=1e-8)
    _assert_close(got, u0, tol)
    for g, r in zip(_fields(calc, "torch"), fields):
        _assert_close(g, r, tol)
    m = calc.matrix.numpy()
    assert m.shape == matrix.shape == (2, 2, 36, 2, 36)
    scale = np.abs(matrix).max(axis=(-3, -1), keepdims=True)  # per (k, b, b') block
    assert (np.abs(m - matrix) <= 1e-10 * scale).all()


def test_batch_geometry_along_one_axis_k_along_another():
    """centers [2, 1, B, 3] (two geometries) x k [1, 3]: batch [2, 3]; each
    member equals the solve of its geometry and k alone (1e-12: one direct
    solve of the same matrix), whose agreement with the JAX package the
    tests above hold."""
    ks = np.array([[1.0, 1.2, 1.4]])
    direction = np.broadcast_to(DIRECTION[:, None, None], (3, 1, 3)).copy()
    ut, _ = plane_wave(k=torch.tensor(ks), direction=torch.tensor(direction))
    ct = biem(create_from_branching_types("ba"), centers=torch.tensor(BATCH_CENTERS[:, None]),
              radii=torch.ones(1, 1, 2, **F64), k=torch.tensor(ks), n_end=4, uin=ut)
    assert ct.density.shape == (2, 3, 2, 16) and ct.matrix.shape == (2, 3, 2, 16, 2, 16)
    near = ct.uscat(torch.tensor(X_NEAR)).numpy()
    for g in range(2):
        for i, k in enumerate(ks[0]):
            u1, _ = plane_wave(k=torch.tensor(k, **F64), direction=torch.tensor(DIRECTION))
            one = biem(create_from_branching_types("ba"),
                       centers=torch.tensor(BATCH_CENTERS[g]), radii=torch.ones(2, **F64),
                       k=torch.tensor(k, **F64), n_end=4, uin=u1)
            _assert_close(ct.density[g, i].numpy(), one.density.numpy(), 1e-12)
            _assert_close(near[:, g, i], one.uscat(torch.tensor(X_NEAR)).numpy(), 1e-12)


def test_batch_geometry_routes():
    """Geometry along the batch is never matrix-free (the JAX package's
    rule): LU up to the tier, dense GMRES beyond, the matrix alone without
    a right-hand side."""
    geo = np.stack([np.arange(16)[:, None] * np.array([4.0, 0, 0]),
                    np.arange(16)[:, None] * np.array([4.5, 0, 0])])
    cpu = torch.device("cpu")
    for solver, n_sys, rhs, want in (("auto", 16 * 1024, True, "gmres"),
                                     ("matfree", 100, True, "gmres"),
                                     ("auto", 100, True, "lu"),
                                     ("auto", 100, False, "matrix")):
        assert _core._route(solver, 16, n_sys, torch.float32, cpu, rhs, False, geo) == want
    assert _core._route("auto", 16, 16 * 1024, torch.float32, cpu, True, False,
                        geo[0]) == "matfree"


def test_dense_assemble_per_k_pid_plain():
    """KD's plain version with a pair map per k equals one call per k, and
    the kernel's CTA order per k is each k's own order."""
    rng = np.random.default_rng(9)
    n_k, n_b, h, n_off = 3, 4, 5, 6

    def rc(*shape):
        return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))

    table, rowf, colf, diag = rc(n_k, n_off, h, h), rc(n_k, n_b, h), rc(n_k, n_b, h), rc(
        n_k, n_b, h)
    sgn = torch.tensor((-1.0) ** np.arange(h))
    pid = torch.tensor(rng.integers(0, n_off, size=(n_k, n_b, n_b)))
    pid = torch.minimum(pid, pid.transpose(1, 2))  # a pair and its mirror share the id
    for pair_major in (True, False):
        got = _dense_assemble_plain(table, pid, rowf, colf, sgn, diag, pair_major)
        for k in range(n_k):
            one = _dense_assemble_plain(table[k : k + 1], pid[k], rowf[k : k + 1],
                                        colf[k : k + 1], sgn, diag[k : k + 1], pair_major)
            assert torch.equal(got[k : k + 1], one)
    order = _pair_order(pid)
    assert order.shape == (n_k, n_b * n_b, 3)
    for k in range(n_k):
        assert torch.equal(order[k], _pair_order(pid[k]))


def test_from_numpy_with_complex_k_and_per_k_centers():
    """A result carried across as numpy arrays (complex k, each k's own
    centers) evaluates to the same field as the port's own result."""
    ks = np.array([1.0 + 0.1j, 1.1 + 0.05j])
    uin, _ = plane_wave(k=torch.tensor(ks),
                        direction=torch.tensor(np.broadcast_to(DIRECTION[:, None], (3, 2)).copy()))
    calc = biem(create_from_branching_types("ba"), centers=torch.tensor(BATCH_CENTERS),
                radii=torch.ones(2, 2, **F64), k=torch.tensor(ks), n_end=N_END, uin=uin)
    back = BIEMResultCalculator.from_numpy(
        create_from_branching_types("ba"), N_END, BATCH_CENTERS, np.ones((2, 2)), ks, None,
        calc.density.numpy(), device="cpu")
    assert back.k.is_complex()
    for a, b in zip(_fields(back, "torch"), _fields(calc, "torch")):
        _assert_close(a, b, 1e-14)
