"""The lattice-FFT route's solves against the JAX package and its anchors, on
the CPU in float64 (split from test_torch_lattice.py so the test workers
share the slow solves; tolerances as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

from test_torch_lattice import (  # noqa: F401 (fixtures)
    F64,
    _args,
    _j_solve,
    _t_solve,
)


def test_8x8_a_lattice_anchor():
    """The JAX package's 64-sphere 2D anchor (tests/test_biem.py): the 8 x 8
    'a' lattice, k = 1, n_end = 19, float64, solver="auto" (the lattice
    route, Graf's table through KG's zero-exponent mode)."""
    c = create_from_branching_types("a")
    uin, _ = plane_wave(k=torch.tensor(1.0, **F64), direction=torch.tensor([1.0, 0.0]))
    calc = biem(c, centers=torch.tensor(lattice_centers(8, 2)), radii=torch.ones(64, **F64),
                k=torch.tensor(1.0, **F64), n_end=19, uin=uin)
    assert calc.matrix is None and int(calc.iters) > 0
    u0 = complex(calc.uscat(torch.zeros(2, 1, **F64))[0])
    assert abs(u0 - (-1.0537360062 + 0.0214642340j)) < 1e-8, u0


def test_lattice_route_warm_start_and_several_k():
    """Two k in one lattice call: the second equals that k alone, and a
    warm start from the converged density converges at once."""
    centers = lattice_centers(8, 2)
    ks = np.array([0.8, 1.2])
    calc = _t_solve("a", centers, ks, 7)
    one = _t_solve("a", centers, ks[1:], 7)
    assert float((calc.density[1] - one.density[0]).abs().max()) <= (
        1e-9 * float(one.density.abs().max()))
    warm = _t_solve("a", centers, ks, 7, density0=calc.density)
    assert int(warm.iters.max()) <= 2
    assert float((warm.density - calc.density).abs().max()) <= (
        1e-9 * float(calc.density.abs().max()))


@pytest.mark.parametrize("solver,route", [("auto", "lu"), ("matfree", "matfree")])
def test_64_spheres_off_a_lattice_take_the_jax_route(solver, route):
    """The route repair: 64 spheres at random, well-separated centres (no
    lattice), 'ba', n_end = 3.  The port used to send every B >= 64 call to
    the lattice route and raise; now it takes the JAX package's route (LU
    at auto, the matrix-free operator when forced) and matches its solve."""
    rng = np.random.default_rng(11)
    pts = []
    while len(pts) < 64:
        p = rng.uniform(-20.0, 20.0, size=3)
        if all(np.linalg.norm(p - q) > 3.0 for q in pts):
            pts.append(p)
    centers = np.array(pts)
    assert _lattice.lattice_routing(centers) is None
    c = create_from_branching_types("ba")
    with pytest.raises(ValueError, match="do not form a lattice"):
        _lattice.lattice_operator(c, 3, centers, *_args(c, 3, centers, np.array([0.9]))[2:])
    assert _core._route(solver, 64, 64 * 9, torch.float64, torch.device("cpu"), True, False,
                        centers) == route
    ks = np.array([0.9])
    got = _t_solve("ba", centers, ks, 3, solver=solver).density.numpy()
    ref = _j_solve("ba", centers, ks, 3, solver=solver).density.to_numpy()
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def test_stable_float32_lattice_past_the_overflow_wall():
    """The guard every new route passes: a 64-sphere line (the lattice
    route, L x 1 grid) at k = 1, pitch 4, n_end = 24, where the unscaled
    float32 (S|R) overflows (|h_46(4)| ~ 1e46): the stable float32 solve
    stays finite and within 1e-3 of float64."""
    centers = np.stack([4.0 * np.arange(64), np.zeros(64)], axis=1)
    f32 = dict(dtype=torch.float32)
    out = {}
    for rdt in (torch.float32, torch.float64):
        f = dict(dtype=rdt)
        uin, _ = plane_wave(k=torch.tensor(1.0, **f), direction=torch.tensor([0.0, 1.0], **f))
        calc = biem(create_from_branching_types("a"), centers=torch.tensor(centers, **f),
                    radii=torch.ones(64, **f), k=torch.tensor(1.0, **f), n_end=24, uin=uin)
        assert calc.iters is not None and calc.matrix is None  # the lattice route
        out[rdt] = calc
    assert bool(torch.isfinite(out[torch.float32].density).all())
    x = torch.tensor([[2.0], [2.5]], **f32)
    u32 = complex(out[torch.float32].uscat(x)[0])
    u64 = complex(out[torch.float64].uscat(x.double())[0])
    assert abs(u32 - u64) <= 1e-3 * abs(u64), (u32, u64)
