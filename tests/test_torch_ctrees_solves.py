"""biem() on trees with a 'c' node ('caa', 'bcaa', 'cbaba') against the JAX
package's golden solves, on the CPU in float64 (split from
test_torch_ctrees.py so the test workers share them; tolerances and goldens
as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

from test_torch_ctrees import (  # noqa: F401 (fixtures)
    F64,
    GOLDEN_CAA,
    ROUTES,
    _lattice,
    _pair,
    _rel,
    _solve,
    _uscat0,
    _x0,
    golden,
)


@pytest.mark.parametrize("route", list(ROUTES))
def test_caa_pair_on_every_route(golden, route):
    """The reference's 'caa' golden (2e-6) and the JAX package's density
    (1e-9) on LU, dense GMRES and both offset-table routes; 'caa' never
    takes the factored operator."""
    calc = _solve("caa", _pair(4), 6, **ROUTES[route])
    ref = golden["pair caa"][0]
    assert (calc.relres is None) == (route == "lu")
    assert abs(_uscat0(calc) - GOLDEN_CAA) <= 2e-6
    assert _rel(calc.density.numpy(), ref["density"]) <= 1e-9
    assert abs(_uscat0(calc) - ref["uscat0"]) <= 1e-9 * abs(ref["uscat0"])


def test_caa_float32_stays_finite_and_tracks_float64():
    """complex64 on the default route (stable) against complex128 (1e-4)."""
    u64 = _uscat0(_solve("caa", _pair(4), 6))
    calc = _solve("caa", _pair(4), 6, rdt=torch.float32)
    assert calc.density.dtype == torch.complex64
    assert abs(_uscat0(calc) - u64) <= 1e-4 * abs(u64)


def test_caa_lattice_route_matches_the_dense_route_and_jax(golden):
    """The 8 x 8 'caa' lattice at pitch 4 in the x0-x1 plane, n_end=3: the
    lattice route (solver="auto"; its half table from KS) against dense
    GMRES and the JAX package's lattice solve (densities 1e-9)."""
    centers = _lattice(8, 4)
    assert _core._route("auto", 64, 64 * 14, torch.float64, torch.device("cpu"), True,
                        False, centers) == "lattice"
    ref = golden["lattice 8x8 caa"][0]
    lat = _solve("caa", centers, 3)
    dense = _solve("caa", centers, 3, solver="gmres")
    assert float(lat.relres) <= 1e-11 and float(dense.relres) <= 1e-11
    for calc in (lat, dense):
        assert _rel(calc.density.numpy(), ref["density"]) <= 1e-9
        assert abs(_uscat0(calc) - ref["uscat0"]) <= 1e-9 * abs(ref["uscat0"])
    unscaled = _solve("caa", centers, 3, stable=False)
    assert _rel(unscaled.density.numpy(), ref["density"]) <= 1e-9


@pytest.mark.parametrize("route", ["factored", "triplet", "lu"])
def test_bcaa_pair_matches_jax(golden, route):
    """'bcaa' (a 'c' node below a 'b' root): the factored route (K3, K2 and
    KB with the 'c' node's degree blocks), the dense route with the band
    scan ("triplet") and the default LU (rotation), against the JAX
    package's density (1e-9)."""
    kw = {"factored": dict(solver="matfree", stable=True),
          "triplet": dict(solver="direct", stable=False,
                          translational_coefficients_method="triplet"),
          "lu": {}}[route]
    calc = _solve("bcaa", _pair(5), 4, **kw)
    ref = golden["pair bcaa"][0]
    assert _rel(calc.density.numpy(), ref["density"]) <= 1e-9


def test_cbaba_pair_by_lu_matches_jax(golden):
    """'cbaba' (6D, a 'c' root over 'b' subtrees) by the default LU."""
    calc = _solve("cbaba", _pair(6), 3)
    ref = golden["pair cbaba"][0]
    assert calc.density.shape == (2, 27)
    assert _rel(calc.density.numpy(), ref["density"]) <= 1e-9
    assert abs(_uscat0(calc) - ref["uscat0"]) <= 1e-9 * abs(ref["uscat0"])


def test_caa_hypercube_matches_jax(golden):
    """The 16 spheres at the corners of {-2, 2}^4 (40 distinct offsets) at
    n_end=6 and two of chip_smoke.py phase 10's wavenumbers in one call,
    against the JAX package's uscat(0) (1e-9)."""
    rows = golden["hypercube caa"][:2]
    ks = np.array([r["k"] for r in rows])
    hyper = np.stack(np.meshgrid(*([[-2.0, 2.0]] * 4), indexing="ij"), axis=-1).reshape(-1, 4)
    c = create_from_branching_types("caa")
    k = torch.tensor(ks, **F64)
    uin, _ = plane_wave(k=k, direction=torch.tensor(np.repeat(_x0(4)[:, None], 2, 1)))
    calc = biem(c, centers=torch.tensor(hyper).expand(2, 16, 4), radii=torch.ones(2, 16, **F64),
                k=k, n_end=6, uin=uin)
    u0 = calc.uscat(torch.zeros(4, 1, **F64)).numpy().reshape(-1)
    for got, row in zip(u0, rows):
        assert abs(got - row["uscat0"]) <= 1e-9 * abs(row["uscat0"])
