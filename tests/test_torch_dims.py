"""Trees rooted at a 'b' or 'bp' node in d >= 4 (bba, bpbpa, bbba), through
the port against the JAX package on the CPU in float64 from the same numpy
inputs.

* The jascome two-sphere problem (unit spheres at (0, +-2, 0, 0), k = 1,
  n_end = 6, plane wave along x0) for 'bba' and 'bpbpa': the golden
  -0.454651-0.423387j of tests/test_biem.py on every route (2e-6, its
  tolerance), and JAX parity of the density, uscat at points, the far
  field and per_ball against the JAX package's LU (1e-8: the port's GMRES
  routes stop at their float64 tolerance).
* 'bbba' (5D) at n_end = 5, two spheres, LU and the forced factored route
  against the JAX package (1e-8).
* The 4D hypercube {-2, 2}^4 (16 unit spheres, pitch 4) at n_end = 6 (H =
  91, 1,456 unknowns) and two k in one call: LU and the forced factored
  route, the first k against the JAX package's LU (1e-8; one k of it
  takes ~50 s on a CPU) and the second against the port's LU at that k alone
  (1e-8), and the factored route in float32 against the JAX package
  (1e-4: float32 rounding, GMRES stopping at 3e-5).
* `max_memory`/`max_n_end` at d = 4 and 5, and `from_numpy` of a 4D JAX
  result, which must evaluate to the JAX package's own field (1e-12).
* The JAX package's solves (one to three minutes of compile each on a
  CPU) are committed in tests/golden/test_torch_dims.npz (`jax_golden`,
  `python tools/torch_golden_from_jax.py --tests`).
* The port alone (a JAX call of these takes 30-60 s on a CPU): the matrix
  without an incident field equals the LU route's, and a point source's
  solve (the quadrature right-hand side in 4D) meets the sound-soft
  boundary condition to 1e-4 of |u_in|.
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import max_memory as j_max_memory
from biem_helmholtz_sphere_tpu import max_n_end as j_max_n_end
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import biem, max_memory, max_n_end, plane_wave, point_source
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

GOLDEN_4D = -0.454651 - 0.423387j  # tests/test_biem.py (jascome_output_4d.csv)
F64 = dict(dtype=torch.float64)
ROUTES = {
    "lu": {},
    "gmres": dict(solver="gmres"),
    "factored": dict(solver="matfree", stable=True),
    "offset-table": dict(solver="matfree", stable=False),
    "force-matrix": dict(force_matrix=True),
}
HYPERCUBE = np.stack(np.meshgrid(*([[-2.0, 2.0]] * 4), indexing="ij"), axis=-1).reshape(-1, 4)
HYPERCUBE_KS = np.array([1.3, 1.7])


def _pair(d):
    centers = np.zeros((2, d))
    centers[0, 1], centers[1, 1] = 2.0, -2.0
    return centers


def _x_axis(d, n_k=None):
    v = np.zeros(d)
    v[0] = 1.0
    return v if n_k is None else np.repeat(v[:, None], n_k, axis=1)


def _points(d):
    """(near points [d, 4] outside the spheres, far directions [d, 3])."""
    rng = np.random.default_rng(d)
    near = rng.normal(size=(d, 4)) * 2.0
    near[0] += 4.0
    far = rng.normal(size=(d, 3))
    return near, far / np.linalg.norm(far, axis=0)


def _assert_close(got, ref, tol):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=tol * np.abs(ref[~nan]).max())


def _fields(calc, lib, d):
    """(near field, far field, per_ball) as numpy."""
    near, far = _points(d)
    if lib == "jax":
        return (tonp(calc.uscat(near)), tonp(calc.uscat(far, far_field=True)),
                tonp(calc.uscat(near[:, :2], per_ball=True)))
    return (calc.uscat(torch.tensor(near)).numpy(),
            calc.uscat(torch.tensor(far), far_field=True).numpy(),
            calc.uscat(torch.tensor(near[:, :2]), per_ball=True).numpy())


def _solve(btype, n_end, centers, ks, rdt=torch.float64, **kw):
    """The port on CPU tensors: a scalar k, or one k per batch entry."""
    c = create_from_branching_types(btype)
    d = c.c_ndim
    f = dict(dtype=rdt)
    k = torch.tensor(ks, **f)
    direction = torch.tensor(_x_axis(d) if k.ndim == 0 else _x_axis(d, len(ks)), **f)
    uin, _ = plane_wave(k=k, direction=direction)
    radii = torch.ones(k.shape + (len(centers),), **f)
    centers = torch.tensor(centers, **f).expand(k.shape + centers.shape)
    return biem(c, centers=centers, radii=radii, k=k, n_end=n_end, uin=uin, **kw)


def _jax_solve(btype, n_end, centers, ks, **kw):
    d = len(centers[0])
    ks = np.asarray(ks)
    uin, _ = j_plane_wave(k=ks, direction=_x_axis(d) if ks.ndim == 0 else _x_axis(d, len(ks)))
    return j_biem(j_tree(btype), centers=np.broadcast_to(centers, ks.shape + centers.shape),
                  radii=np.ones(ks.shape + (len(centers),)), k=ks, n_end=n_end, uin=uin, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("btype", ["bba", "bpbpa"])
def test_4d_golden_on_every_route(btype, route):
    calc = _solve(btype, 6, _pair(4), 1.0, **ROUTES[route])
    assert (calc.relres is None) == (route in ("lu", "force-matrix"))
    assert (calc.matrix is None) == (route not in ("lu", "gmres", "force-matrix"))
    u = complex(calc.uscat(torch.zeros(4, 1, **F64))[0])
    assert abs(u - GOLDEN_4D) <= 2e-6


def jax_golden():
    """The JAX package's solves the fixtures below read (each compiles for
    one to three minutes on the CPU): the jascome pair on 'bba' and
    'bpbpa', the 5D pair and the first k of the hypercube, by its default
    route (a direct LU), with their fields."""
    out = {}
    for name, (btype, n_end, centers) in {
            "bba": ("bba", 6, _pair(4)), "bpbpa": ("bpbpa", 6, _pair(4)),
            "bbba": ("bbba", 5, _pair(5))}.items():
        calc = _jax_solve(btype, n_end, centers, 1.0)
        out[f"{name} density"] = tonp(calc.density)
        for key, v in zip(("near", "far", "per_ball"), _fields(calc, "jax", len(centers[0]))):
            out[f"{name} {key}"] = v
    calc = _jax_solve("bba", 6, HYPERCUBE, HYPERCUBE_KS[0])
    out["hypercube near"] = tonp(calc.uscat(_points(4)[0]))
    out["hypercube density"] = tonp(calc.density)
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_dims")


def _jax_pair(jax_values, name):
    """(fields, density) of a pair's JAX solve, committed (`jax_golden`)."""
    return (tuple(jax_values[f"{name} {key}"] for key in ("near", "far", "per_ball")),
            jax_values[f"{name} density"])


@pytest.fixture(scope="module", params=["bba", "bpbpa"])
def jax_4d(request, jax_values):
    return (request.param, *_jax_pair(jax_values, request.param))


@pytest.fixture(scope="module")
def jax_5d(jax_values):
    return _jax_pair(jax_values, "bbba")


@pytest.fixture(scope="module")
def jax_hypercube(jax_values):
    """(near field, density) of the JAX package at the first k, committed
    (each field evaluation is a compile of its own there: the two-sphere
    tests hold the far field and per_ball)."""
    return jax_values["hypercube near"], jax_values["hypercube density"]


@pytest.mark.parametrize("d,n_end,n_balls", [(4, 3, 1), (4, 6, 2), (4, 20, 16), (5, 4, 2),
                                             (5, 8, 3)])
def test_memory_model_matches_jax_beyond_3d(d, n_end, n_balls):
    assert max_memory(c_ndim=d, n_end=n_end, n_balls=n_balls) == j_max_memory(
        c_ndim=d, n_end=n_end, n_balls=n_balls)
    for limit in (10**6, 10**9, 10**12):
        assert max_n_end(c_ndim=d, memory_limit=limit, n_balls=n_balls) == j_max_n_end(
            c_ndim=d, memory_limit=limit, n_balls=n_balls)


def test_4d_matrix_only_is_the_solved_matrix():
    """No incident field: the matrix alone, equal to the one the LU route
    solved with (force_matrix), entry for entry."""
    c = create_from_branching_types("bba")
    k = torch.tensor(1.0, **F64)
    alone = biem(c, centers=torch.tensor(_pair(4)), radii=torch.ones(2, **F64), k=k, n_end=6)
    assert alone.density is None and alone.matrix.shape == (2, 91, 2, 91)
    solved = _solve("bba", 6, _pair(4), 1.0, force_matrix=True)
    assert torch.equal(alone.matrix, solved.matrix)


def test_4d_point_source_meets_the_boundary_condition():
    """A point source off the pair (the quadrature right-hand side in 4D):
    the sound-soft residual |u_in + u_scat| on both spheres is small
    against |u_in| there (n_end=8: 1e-4)."""
    c = create_from_branching_types("bba")
    k = torch.tensor(1.0, **F64)
    uin, _ = point_source(k=k, source=torch.tensor([0.0, 0.0, 3.0, 0.5], **F64))
    calc = biem(c, centers=torch.tensor(_pair(4)), radii=torch.ones(2, **F64), k=k, n_end=8,
                uin=uin)
    rng = np.random.default_rng(9)
    v = rng.normal(size=(4, 32))
    v /= np.linalg.norm(v, axis=0)
    x = torch.tensor(np.concatenate([_pair(4)[b][:, None] + 1.0000001 * v for b in (0, 1)],
                                    axis=1))
    u_in, u_sc = calc.uin(x), calc.uscat(x)
    assert float((u_in + u_sc).abs().max()) <= 1e-4 * float(u_in.abs().max())
