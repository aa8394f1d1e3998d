"""2D trees ('a') through the port's biem() on every route, against the
reference's golden values and the JAX package on the CPU in float64, on
the same numpy inputs.

Tolerances: the goldens as tests/test_biem.py holds the JAX package
(2e-6 on the jascome value, 1e-10 on the converged accuracy-sweep row).
Against the JAX package's lattice solve, which stops at the float64 GMRES
tolerance 1e-11: the port's lattice route (the same iteration) within
1e-10 of the largest value, a direct or dense-GMRES solve within 1e-9
(the lattice tests' bound between two solves of which one iterates), and
the other inputs' lattice solves (the quadrature right-hand sides)
within 1e-9; two direct solves (geometry along the batch) within
1e-10.  One
density evaluated by both packages: 1e-11 of the largest field value (64
circles' fields summed, each of the size of the total).  Float32 past the
overflow wall within 1e-3 of float64.

The JAX package's lattice solves compile for minutes on the CPU: its
values are committed in tests/golden/test_torch_2d.npz (`jax_golden`
below, `python tools/torch_golden_from_jax.py --tests`).
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
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave, point_source
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

F64 = dict(dtype=torch.float64)
PAIR = np.array([[0.0, 2.0], [0.0, -2.0]])
# the 8 x 8 lattice of the n_balls family with unequal radii, Robin data,
# two k: the JAX package solves it on its lattice route (radii 0.4-0.7 at
# k 0.7 and 1.1: ~180 GMRES steps a k, where radii 0.6-1.0 at k 1.3 and
# 2.1 take 1,200-1,500)
CENTERS = lattice_centers(8, 2)
RADII = 0.4 + 0.3 * np.random.default_rng(8).random(64)
KS = np.array([0.7, 1.1])
N_END = 6
X_NEAR = np.array([[0.0, 0.0, -3.0, 2.1], [0.0, 4.0, 1.0, 2.1]])  # the last inside a circle
X_FAR = np.array([[1.0, 0.6, 0.0], [0.0, 0.8, -1.0]])
ROUTES = {"lattice": {}, "lattice-stable": dict(stable=True), "direct": dict(solver="direct"),
          "gmres": dict(solver="gmres"), "direct-stable": dict(solver="direct", stable=True)}


def _pair(n_end, rdt=torch.float64, k=1.0, uin_k=1.0, **kw):
    f = dict(dtype=rdt)
    uin, _ = plane_wave(k=torch.tensor(uin_k, **f), direction=torch.tensor([1.0, 0.0], **f))
    calc = biem(create_from_branching_types("a"), centers=torch.tensor(PAIR, **f),
                radii=torch.ones(2, **f), k=torch.tensor(k, **f), n_end=n_end, uin=uin, **kw)
    return calc, complex(calc.uscat(torch.zeros(2, 1, **f))[0])


@pytest.mark.parametrize("stable", [None, True, False])
@pytest.mark.parametrize("solver", ["auto", "direct", "gmres", "matfree"])
def test_2d_golden_on_every_route(solver, stable):
    """The jascome 2D value (tests/test_biem.py GOLDEN 'a': two unit circles
    at (0, +-2), k = 1, n_end = 9) on every route solver= can force, the
    scale-compensated (KG with the ball-max fold) and the plain table."""
    calc, u0 = _pair(9, solver=solver, stable=stable)
    assert abs(u0 - (-1.355933 - 0.657813j)) < 2e-6, u0
    assert (calc.relres is None) == (solver in ("auto", "direct"))


@pytest.mark.parametrize("route", ["auto", "gmres", "matfree", "matfree-stable"])
def test_2d_accuracy_sweep_golden(route):
    """The reference's converged accuracy_k_a.csv row (tests/test_biem.py
    ACCURACY_SWEEP_GOLDEN 'a'): k = 16, n_end = 32, the incident wave at
    k = 1."""
    _, u0 = _pair(32, k=16.0, **ROUTES.get(route, {}))
    assert abs(u0 - (1.0035487245418335 + 0.09104501905173143j)) < 1e-10, u0


@pytest.mark.parametrize("solver", ["direct", "gmres", "matfree"])
def test_2d_float32_past_the_overflow_wall(solver):
    """The pair at n_end = 24, where the unscaled float32 (S|R) overflows
    (|h_46(4)| ~ 1e46): the stable float32 routes (KG's fold) stay finite
    and within 1e-3 of float64."""
    c32, u32 = _pair(24, torch.float32, solver=solver)
    _, u64 = _pair(24, solver="direct")
    assert bool(torch.isfinite(c32.density).all())
    assert abs(u32 - u64) <= 1e-3 * abs(u64), (u32, u64)
    plain, _ = _pair(24, torch.float32, solver="direct", stable=False)
    assert not bool(torch.isfinite(plain.density).all())  # the wall the fold removes


def _kw(lib, ks=KS, centers=CENTERS, field="plane-wave", beta=0.5):
    """biem()'s arguments on either package: the lattice at each k, Robin
    data (alpha 1, beta), a plane wave along (1, -2)/sqrt(5) (its tags
    kept) or a point source at (0.5, 3.5) (the quadrature RHS)."""
    n_k, n_b = len(ks), np.shape(centers)[-2]
    centers = np.broadcast_to(centers, (n_k, n_b, 2)).copy()
    kw = dict(radii=np.broadcast_to(RADII[:n_b], (n_k, n_b)).copy(), n_end=N_END, alpha=1.0,
              beta=beta,
              eta=np.ones(n_k))
    if field == "plane-wave":
        direction = np.broadcast_to(np.array([1.0, -2.0])[:, None] / np.sqrt(5.0), (2, n_k)).copy()
        make = j_plane_wave if lib == "jax" else plane_wave
        args = dict(k=ks, direction=direction)
    else:
        make = j_point_source if lib == "jax" else point_source
        args = dict(k=ks, source=np.broadcast_to(np.array([0.5, 3.5])[:, None], (2, n_k)).copy())
    if lib == "jax":
        k = C.of(np.asarray(ks)) if np.iscomplexobj(ks) else ks
        uin, uin_grad = make(**{**args, "k": k})
        return dict(kw, centers=centers, k=k, uin=uin, uin_grad=uin_grad)
    t = {key: torch.tensor(v) for key, v in args.items()}
    uin, uin_grad = make(**t)
    return dict({key: torch.tensor(v) for key, v in kw.items() if key != "n_end"},
                n_end=N_END, alpha=1.0, beta=beta, centers=torch.tensor(centers),
                k=torch.tensor(ks), uin=uin, uin_grad=uin_grad)


def _fields(calc, lib):
    if lib == "jax":
        return {"density": calc.density.to_numpy(), "near": calc.uscat(X_NEAR).to_numpy(),
                "far": calc.uscat(X_FAR, far_field=True).to_numpy(),
                "per_ball": calc.uscat(X_NEAR[:, :3], per_ball=True).to_numpy()}
    return {"density": calc.density.numpy(), "near": calc.uscat(torch.tensor(X_NEAR)).numpy(),
            "far": calc.uscat(torch.tensor(X_FAR), far_field=True).numpy(),
            "per_ball": calc.uscat(torch.tensor(X_NEAR[:, :3]), per_ball=True).numpy()}


def _assert_fields(got, ref, tol):
    for key in ref:
        r, g = ref[key], got[key]
        assert g.shape == r.shape, key
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(g), nan)
        assert np.abs(g[~nan] - r[~nan]).max() <= tol * np.abs(r[~nan]).max(), key


INPUTS = ["batch-geometry", "point-source", "plane-wave-untagged"]


def _input_kw(case, lib):
    """test_2d_inputs_match_jax's biem() arguments on either package."""
    ks, centers, field = KS, CENTERS, "plane-wave"
    if case == "batch-geometry":
        centers = np.stack([CENTERS, CENTERS * 1.15])
    elif case == "point-source":
        field = "point-source"
    kw = _kw(lib, ks, centers, field)
    if case == "plane-wave-untagged":
        u, g = kw["uin"], kw["uin_grad"]
        kw["uin"], kw["uin_grad"] = (lambda x, /, u=u: u(x)), (lambda x, /, g=g: g(x))
    return kw


def jax_golden():
    """The JAX package's values the tests below read: its solve of the
    lattice (its default route, the lattice FFT, with its GMRES steps) and
    of each case of INPUTS, with their fields."""
    calc = j_biem(j_tree("a"), **_kw("jax"))
    out = {f"lattice {key}": v for key, v in _fields(calc, "jax").items()}
    out["lattice iters"] = np.asarray(calc.iters) if calc.matrix is None else np.zeros(0)
    for case in INPUTS:
        fields = _fields(j_biem(j_tree("a"), **_input_kw(case, "jax")), "jax")
        out.update({f"{case} {key}": v for key, v in fields.items()})
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_2d")


@pytest.fixture(scope="module")
def jax_2d(jax_values):
    """The JAX package's solve of the lattice (its default route, the
    lattice FFT: no matrix, GMRES steps) with its fields, committed."""
    assert jax_values["lattice iters"].size and (jax_values["lattice iters"] > 0).all()
    return {key: jax_values[f"lattice {key}"] for key in ("density", "near", "far", "per_ball")}


def test_2d_matrix_only_and_one_circle():
    """Without an incident field the result holds the matrix alone, the
    LU route's; one circle takes the diagonal solve, which the LU of its
    one block agrees with."""
    kw = _kw("torch")
    kw.pop("uin"), kw.pop("uin_grad")
    c = create_from_branching_types("a")
    only = biem(c, **{**kw, "beta": 0.0})
    assert only.density is None and only.matrix.shape == (2, 64, 11, 64, 11)
    kw_lu = _kw("torch", beta=0.0)
    lu = biem(c, solver="direct", **kw_lu)
    assert torch.equal(only.matrix, lu.matrix)
    one = _kw("torch", centers=CENTERS[:1], beta=0.0)
    diag = biem(c, **one)
    full = biem(c, force_matrix=True, **one)
    assert diag.matrix is None and full.matrix is not None
    assert float((diag.density - full.density).abs().max()) <= (
        1e-12 * float(full.density.abs().max()))
