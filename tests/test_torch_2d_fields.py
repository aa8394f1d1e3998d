"""2D fields through the port's biem() on every route against the JAX
package's lattice solves (committed), and other inputs, on the CPU in
float64 (split from test_torch_2d.py so the test workers share them;
tolerances and the committed JAX values as there)."""

import numpy as np
import pytest

from biem_helmholtz_sphere_tpu_torch import BIEMResultCalculator, biem
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

from test_torch_2d import (  # noqa: F401 (fixtures)
    CENTERS,
    INPUTS,
    KS,
    N_END,
    RADII,
    ROUTES,
    _assert_fields,
    _fields,
    _input_kw,
    _kw,
    jax_2d,
    jax_values,
)


@pytest.mark.parametrize("route", list(ROUTES))
def test_2d_fields_match_jax(jax_2d, route):
    """Density, near field (a point inside a circle NaN), far field and
    per-ball field of the lattice of unequal circles at two k with Robin
    data, against the JAX package's lattice solve: the lattice route
    (KG's table, FFT), the dense routes (KG + KD) and dense GMRES, stable
    and plain."""
    calc = biem(create_from_branching_types("a"), **ROUTES[route], **_kw("torch"))
    assert (calc.matrix is None) == route.startswith("lattice")
    _assert_fields(_fields(calc, "torch"), jax_2d,
                   1e-10 if route.startswith("lattice") else 1e-9)


@pytest.mark.parametrize("case", INPUTS)
def test_2d_inputs_match_jax(jax_values, case):
    """Geometry that varies along the batch (the dense route), a point
    source and an untagged plane wave (both by the quadrature right-hand
    side) in 2D, each against the same call of the JAX package (committed:
    `jax_golden`; complex k in 2D: tests/test_torch_complex_k.py)."""
    got = _fields(biem(create_from_branching_types("a"), **_input_kw(case, "torch")), "torch")
    ref = {key: jax_values[f"{case} {key}"] for key in ("density", "near", "far", "per_ball")}
    # batch geometry: LU in both packages; the rest: each package's GMRES
    _assert_fields(got, ref, 1e-10 if case == "batch-geometry" else 1e-9)


def test_from_numpy_of_a_2d_jax_lattice_result(jax_2d):
    """The JAX package's 2D lattice result carried across with from_numpy
    evaluates to the same near, far and per-ball fields."""
    port = BIEMResultCalculator.from_numpy(
        create_from_branching_types("a"), N_END, np.broadcast_to(CENTERS, (2, 64, 2)),
        np.broadcast_to(RADII, (2, 64)), KS, np.ones(2), jax_2d["density"], device="cpu")
    _assert_fields(_fields(port, "torch"), jax_2d, 1e-11)
