"""biem() with the Gumerov-Duraiswami translation on every plain route
against the JAX package's solves, on the CPU (split from
test_torch_gumerov.py so the test workers share them; tolerances and the
committed JAX values as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation import gd_coaxial as j_gd_coaxial
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.translation import _gumerov, gd_coaxial

from test_torch_gumerov import (  # noqa: F401 (fixtures)
    F64,
    SOLVES,
    _lattice,
    _overflow_call,
    _port,
    _solve_call,
    jax_values,
)


@pytest.mark.parametrize("case", list(SOLVES))
def test_biem_gumerov_matches_jax(jax_values, case, monkeypatch):
    """biem(..., translational_coefficients_method="gumerov", stable=False)
    on each plain route against the JAX package's solve of the same call
    (committed: `jax_golden`; the port's route checked by `_core._route`,
    its ladders by a count): densities within 1e-9 of their largest
    entry."""
    route = SOLVES[case][-1]
    seen, ladders = [], []
    route_of = _core._route
    monkeypatch.setattr(_core, "_route", lambda *a: seen.append(route_of(*a)) or seen[-1])
    monkeypatch.setattr(_gumerov, "gd_coaxial",
                        lambda *a, gd=_gumerov.gd_coaxial, **kw: ladders.append(1) or gd(*a, **kw))
    direction, call = _solve_call(case)
    uin, _ = plane_wave(k=torch.tensor(call["k"]), direction=torch.tensor(direction))
    got = _port(call, uin).density.numpy()
    assert seen == [route] and ladders
    ref = jax_values[f"solve {case}"]
    n_k, n_balls = call["radii"].shape
    assert got.shape == ref.shape == (n_k, n_balls, call["n_end"] ** 2)
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("solver", ["direct", "matfree"])
def test_scaled_routes_ignore_gumerov(solver, monkeypatch):
    """The scale-compensated routes build their own table whatever the
    method, as the JAX package's: "gumerov" with stable=True runs no
    ladder and solves as the default method does."""
    ladders = []
    monkeypatch.setattr(_gumerov, "gd_coaxial", lambda *a, **kw: ladders.append(1))
    c = create_from_branching_types("ba")
    k = torch.tensor(1.3, **F64)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **F64))
    call = dict(centers=torch.tensor(_lattice(3)), radii=torch.ones(9, **F64), k=k, n_end=5,
                uin=uin, solver=solver, stable=True)
    got = biem(c, translational_coefficients_method="gumerov", **call).density
    assert not ladders
    assert torch.equal(got, biem(c, **call).density)


def test_float32_past_the_overflow_wall_gumerov(jax_values):
    """Two unit spheres at t = 4, k = 1, n_end = 24 in float32 with
    "gumerov" on the plain dense route (the twin of test_torch_biem.py's
    test_float32_past_the_overflow_wall): the ladders read h_{n'}(4) past
    float32's range (n' >= 44), so the coaxial factor's entries of high
    degree are not finite exactly where the JAX package's are not, and the
    solve is not finite in either package.  The port's degree-group
    sandwich keeps the other degree blocks of the matrix finite, where the
    JAX package's dense product spreads the overflow to every entry (its
    solve committed: `jax_golden`)."""
    c, cj = create_from_branching_types("ba"), j_tree("ba")
    n_end = 24
    r = np.array([4.0], np.float32)
    got = gd_coaxial(c, torch.tensor(r), n_end, torch.tensor(1.0)).numpy()
    ref = tonp(j_gd_coaxial(cj, r, n_end, np.float32(1.0)))
    assert (np.isfinite(got) == np.isfinite(ref)).all()
    assert not np.isfinite(got).all() and np.isfinite(got).any()
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-5 * np.abs(ref[fin]).max()
    uin, _ = plane_wave(k=torch.tensor(1.0), direction=torch.tensor([1.0, 0.0, 0.0]))
    calc = _port(_overflow_call(), uin)
    dens, j_dens = calc.density.numpy(), jax_values["overflow density"]
    assert (np.isfinite(dens) == np.isfinite(j_dens)).all()
    assert not np.isfinite(dens).any()
    fin_m, j_fin_m = np.isfinite(calc.matrix.numpy()), jax_values["overflow matrix finite"]
    assert (fin_m | ~j_fin_m).all() and not fin_m.all()
