"""Complex wavenumbers through the port against the JAX package, on the
CPU in float64 from the same numpy inputs.

The README problem (two sound-soft unit spheres at (0, +-2, 0), n_end=6,
plane wave along x0) at k = 1 + 0.1j, an absorbing medium, on every route
of `biem()`: the default direct LU, dense GMRES, the factored and the
offset-table matrix-free GMRES, and force_matrix, each against the JAX
package's direct solve (its routes agree with each other to 1e-14 here).
Compared: uscat(0), uscat at random points outside the spheres (and one
inside, NaN), the far field and per_ball.

Tolerances: the direct routes solve the same matrix, entry by entry the
same arithmetic in another order (1e-10 of the largest value); the GMRES
routes stop at the float64 tolerance 1e-11 of the preconditioned residual
(1e-8); float32 on the factored route against the JAX package's float64
(1e-4, as the float32 README golden).  The JAX package's solves are
committed in tests/golden/test_torch_complex_k.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`); its incident fields are called
live.
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu import point_source as j_point_source
from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave, point_source
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

K = 1.0 + 0.1j
N_END = 6
CENTERS = np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
DIRECTION = np.array([1.0, 0.0, 0.0])
F64 = dict(dtype=torch.float64)
ROUTES = {
    "lu": {},
    "gmres": dict(solver="gmres"),
    "factored": dict(solver="matfree", stable=True),
    "offset-table": dict(solver="matfree", stable=False),
    "force-matrix": dict(force_matrix=True),
}
TOL = {"lu": 1e-10, "force-matrix": 1e-10, "gmres": 1e-8, "factored": 1e-8,
       "offset-table": 1e-8}


def _points():
    """Near points: 6 outside both spheres and one inside sphere 0."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40)) * 3.0
    r = np.linalg.norm(x[:, :, None] - CENTERS.T[:, None, :], axis=0)
    x = x[:, (r > 1.05).all(-1)][:, :6]
    return np.concatenate([x, [[0.2], [2.1], [0.1]]], axis=1)


X_NEAR = _points()
X_FAR = np.random.default_rng(6).normal(size=(3, 4))
X_FAR /= np.linalg.norm(X_FAR, axis=0)


def _ck(k):
    k = np.asarray(k)
    return C(np.array(k.real), np.array(k.imag))


def _outputs(calc, lib):
    """(uscat(0), near, far, per_ball) as numpy."""
    if lib == "jax":
        def ev(x, **kw):
            return tonp(calc.uscat(x, **kw))
    else:
        def ev(x, **kw):
            return calc.uscat(torch.tensor(x), **kw).numpy()
    return (ev(np.zeros((3, 1))), ev(X_NEAR), ev(X_FAR, far_field=True),
            ev(X_NEAR[:, :3], per_ball=True))


def _assert_close(got, ref, tol):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=tol * np.abs(ref[~nan]).max())


def _jax_lu():
    uin, _ = j_plane_wave(k=_ck(K), direction=DIRECTION)
    calc = j_biem(j_tree("ba"), centers=CENTERS, radii=np.ones(2), k=_ck(K), n_end=N_END,
                  uin=uin)
    return _outputs(calc, "jax")


@pytest.fixture(scope="module")
def jax_lu():
    """`_jax_lu`'s outputs, committed (`jax_golden`)."""
    values = _jax_golden.load("test_torch_complex_k")
    return tuple(values[f"lu {i}"] for i in range(sum(k.startswith("lu ") for k in values)))


def _port(dtype=torch.float64, **kw):
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    uin, _ = plane_wave(k=torch.tensor(K, dtype=cdt),
                        direction=torch.tensor(DIRECTION, dtype=dtype))
    return biem(create_from_branching_types("ba"), centers=torch.tensor(CENTERS, dtype=dtype),
                radii=torch.ones(2, dtype=dtype), k=torch.tensor(K, dtype=cdt), n_end=N_END,
                uin=uin, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_complex_k_route_matches_jax(jax_lu, route):
    calc = _port(**ROUTES[route])
    assert calc.k.is_complex() and calc.density.dtype == torch.complex128
    assert (calc.relres is None) == (route in ("lu", "force-matrix"))
    assert (calc.matrix is None) == (route in ("factored", "offset-table"))
    for got, ref in zip(_outputs(calc, "torch"), jax_lu):
        assert got.shape == ref.shape
        _assert_close(got, ref, TOL[route])


def test_complex_k_golden():
    """uscat(0) at k = 1 + 0.1j on the default route (a direct LU), the
    JAX package's value on the CPU in float64."""
    u = complex(_port().uscat(torch.zeros(3, 1, **F64))[0])
    assert abs(u - (-0.6537330055594149 - 0.6160661760970538j)) <= 1e-12


def test_complex_k_float32_factored(jax_lu):
    calc = _port(torch.float32, solver="matfree")
    assert calc.relres is not None and calc.density.dtype == torch.complex64
    u0 = complex(calc.uscat(torch.zeros(3, 1))[0])
    ref = complex(jax_lu[0][0])
    assert abs(u0 - ref) <= 1e-4 * abs(ref)


@pytest.mark.parametrize("kind", ["plane-wave", "point-source"])
def test_incident_fields_with_complex_k(kind):
    ks = np.array([1.0 + 0.1j, 2.0 + 0.5j])
    x = np.random.default_rng(7).normal(size=(3, 5, 2)) * 2.0
    if kind == "plane-wave":
        v = np.array([[1.0, 0.0], [2.0, 1.0], [0.0, -1.0]])
        uj, gj = j_plane_wave(k=_ck(ks), direction=v)
        ut, gt = plane_wave(k=torch.tensor(ks), direction=torch.tensor(v))
    else:
        v = np.array([[0.3, 0.0], [0.0, 5.0], [4.0, 0.0]])
        uj, gj = j_point_source(k=_ck(ks), source=v)
        ut, gt = point_source(k=torch.tensor(ks), source=torch.tensor(v))
    for fj, ft in ((uj, ut), (gj, gt)):
        ref, got = tonp(fj(x)), ft(torch.tensor(x)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def _batch_args():
    """(k, direction, centers, radii) of test_complex_k_in_a_batch."""
    ks = np.array([[1.0, 1.3, 1.7]]) + 1j * np.array([[0.05], [0.2]])
    direction = np.broadcast_to(DIRECTION[:, None, None], (3, 2, 3)).copy()
    return ks, direction, CENTERS[None, None], np.ones((1, 1, 2))


def test_complex_k_in_a_batch():
    """k [2, 3] complex (two absorptions x three real parts) over one
    geometry, centers [1, 1, B, 3]: density and uscat against the JAX
    package (the default route, a direct LU; committed: `jax_golden`)."""
    ks, direction, centers, radii = _batch_args()
    ut, _ = plane_wave(k=torch.tensor(ks), direction=torch.tensor(direction))
    ct = biem(create_from_branching_types("ba"), centers=torch.tensor(centers),
              radii=torch.tensor(radii), k=torch.tensor(ks), n_end=N_END, uin=ut)
    ref = _jax_golden.load("test_torch_complex_k")
    assert ct.density.shape == (2, 3, 2, N_END * N_END)
    _assert_close(ct.density.numpy(), ref["batch density"], 1e-10)
    _assert_close(ct.uscat(torch.tensor(X_NEAR)).numpy(), ref["batch near"], 1e-10)


def _lattice_2d():
    """test_2d_complex_k_lattice_matches_jax's biem() arguments (numpy), its
    k, direction and evaluation calls (name: (x, far_field, per_ball))."""
    centers = lattice_centers(8, 2)
    radii = 0.4 + 0.3 * np.random.default_rng(8).random(64)
    ks = np.array([0.7, 1.1]) + 0.2j
    direction = np.broadcast_to(np.array([1.0, -2.0])[:, None] / np.sqrt(5.0), (2, 2)).copy()
    kw = dict(centers=np.broadcast_to(centers, (2, 64, 2)).copy(),
              radii=np.broadcast_to(radii, (2, 64)).copy(), n_end=6, alpha=1.0, beta=0.5,
              eta=np.ones(2))
    x_near = np.array([[0.0, 0.0, -3.0, 2.1], [0.0, 4.0, 1.0, 2.1]])  # the last inside
    x_far = np.array([[1.0, 0.6, 0.0], [0.0, 0.8, -1.0]])
    evals = {"near": (x_near, False, False), "far": (x_far, True, False),
             "per_ball": (x_near[:, :3], False, True)}
    return kw, ks, direction, evals


def jax_golden():
    """The JAX package's values the tests read: the 2D lattice solve of
    test_2d_complex_k_lattice_matches_jax (its lattice route compiles for
    minutes on the CPU: the density, its fields, whether it formed a
    matrix), the README pair's LU (`_jax_lu`) and the k batch of
    test_complex_k_in_a_batch."""
    kw, ks, direction, evals = _lattice_2d()
    j_uin, j_grad = j_plane_wave(k=C.of(ks), direction=direction)
    ref = j_biem(j_tree("a"), k=C.of(ks), uin=j_uin, uin_grad=j_grad, **kw)
    out = {"lattice density": ref.density.to_numpy(),
           "lattice matrix formed": np.asarray(ref.matrix is not None)}
    for name, (x, far, each) in evals.items():
        out[f"lattice {name}"] = ref.uscat(x, far_field=far, per_ball=each).to_numpy()
    out.update({f"lu {i}": v for i, v in enumerate(_jax_lu())})
    ks, direction, centers, radii = _batch_args()
    uj, _ = j_plane_wave(k=_ck(ks), direction=direction)
    cj = j_biem(j_tree("ba"), centers=centers, radii=radii, k=_ck(ks), n_end=N_END, uin=uj)
    out["batch density"], out["batch near"] = tonp(cj.density), tonp(cj.uscat(X_NEAR))
    return out


def test_2d_complex_k_lattice_matches_jax():
    """Complex k in 2D: the 8 x 8 'a' lattice of unequal circles (radii
    0.4-0.7, Robin data alpha 1 beta 0.5, k 0.7 + 0.2i and 1.1 + 0.2i, a
    plane wave along (1, -2)/sqrt(5)), the lattice route in both packages
    (KG's table, the block convolution): density, near, far and per-ball
    fields within 1e-9 of the largest value (both iterate to the float64
    tolerance 1e-11; the JAX package's committed: `jax_golden`)."""
    kw, ks, direction, evals = _lattice_2d()
    ref = _jax_golden.load("test_torch_complex_k")
    uin, grad = plane_wave(k=torch.tensor(ks), direction=torch.tensor(direction))
    got = biem(create_from_branching_types("a"), k=torch.tensor(ks), uin=uin, uin_grad=grad,
               **{key: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
                  for key, v in kw.items()})
    # the lattice route in both packages
    assert got.matrix is None and not bool(ref["lattice matrix formed"])
    pairs = [(got.density.numpy(), ref["lattice density"])]
    for name, (x, far, each) in evals.items():
        pairs.append((got.uscat(torch.tensor(x), far_field=far, per_ball=each).numpy(),
                      ref[f"lattice {name}"]))
    for g, r in pairs:
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(g), nan)
        assert np.abs(g[~nan] - r[~nan]).max() <= 1e-9 * np.abs(r[~nan]).max()
