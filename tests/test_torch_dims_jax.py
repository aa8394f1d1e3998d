"""Trees rooted at a 'b' or 'bp' node in d >= 4 against the JAX package's
solves (committed), on the CPU in float64: the 4D pair's fields, 5D, the
hypercube and from_numpy (split from test_torch_dims.py so the test
workers share them; tolerances as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch import BIEMResultCalculator
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

from test_torch_dims import (  # noqa: F401 (fixtures)
    HYPERCUBE,
    HYPERCUBE_KS,
    ROUTES,
    _assert_close,
    _fields,
    _pair,
    _points,
    _solve,
    jax_4d,
    jax_5d,
    jax_hypercube,
    jax_values,
)


@pytest.mark.parametrize("route", ["lu", "gmres", "factored", "offset-table"])
def test_4d_fields_match_jax(jax_4d, route):
    """Against the JAX package's default route (a direct LU); the port's
    GMRES routes stop at their float64 tolerance, which bounds the
    agreement at ~1e-9."""
    btype, fields, dens = jax_4d
    calc = _solve(btype, 6, _pair(4), 1.0, **ROUTES[route])
    _assert_close(calc.density.numpy(), dens, 1e-8)
    for got, ref in zip(_fields(calc, "torch", 4), fields):
        assert got.shape == ref.shape
        _assert_close(got, ref, 1e-8)


@pytest.mark.parametrize("route", ["lu", "factored"])
def test_5d_matches_jax(jax_5d, route):
    fields, dens = jax_5d
    calc = _solve("bbba", 5, _pair(5), 1.0, **ROUTES[route])
    _assert_close(calc.density.numpy(), dens, 1e-8)
    for got, ref in zip(_fields(calc, "torch", 5), fields):
        _assert_close(got, ref, 1e-8)


@pytest.mark.parametrize("route", ["lu", "factored"])
def test_4d_hypercube_matches_jax(jax_hypercube, route):
    """16 spheres, 40 distinct offsets along every axis and diagonal (the
    rotation to t^ = +-e_axis included), two k in one call."""
    near_ref, dens = jax_hypercube
    calc = _solve("bba", 6, HYPERCUBE, HYPERCUBE_KS, **ROUTES[route])
    assert calc.density.shape == (2, 16, 91)
    _assert_close(calc.density[0].numpy(), dens, 1e-8)
    _assert_close(calc.uscat(torch.tensor(_points(4)[0])).numpy()[:, 0], near_ref, 1e-8)
    alone = _solve("bba", 6, HYPERCUBE, HYPERCUBE_KS[1])
    _assert_close(calc.density[1].numpy(), alone.density.numpy(), 1e-8)


def test_4d_hypercube_float32_factored_matches_jax(jax_hypercube):
    near_ref, dens = jax_hypercube
    calc = _solve("bba", 6, HYPERCUBE, HYPERCUBE_KS[0], torch.float32, solver="matfree")
    assert calc.density.dtype == torch.complex64 and float(calc.relres) <= 3e-5
    _assert_close(calc.density.numpy().astype(np.complex128), dens, 1e-4)
    near = torch.tensor(_points(4)[0], dtype=torch.float32)
    _assert_close(calc.uscat(near).numpy(), near_ref, 1e-4)


def test_from_numpy_of_a_4d_jax_result(jax_4d):
    """A JAX result carried across as numpy arrays evaluates, through the
    port's general evaluation, to the JAX package's own field."""
    btype, fields, dens = jax_4d
    back = BIEMResultCalculator.from_numpy(
        create_from_branching_types(btype), 6, _pair(4), np.ones(2), 1.0, None, dens,
        device="cpu")
    assert back.density.dtype == torch.complex128
    for got, ref in zip(_fields(back, "torch", 4), fields):
        _assert_close(got, ref, 1e-12)
