"""Doctests of the port's modules (stdlib doctest, as test_doctests.py
runs them for the JAX package)."""

import doctest
import importlib
import pkgutil

import pytest

import biem_helmholtz_sphere_tpu_torch as pkg

MODULES = sorted(
    info.name for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
)


@pytest.mark.parametrize("modname", MODULES)
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    runner = doctest.DocTestRunner(
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS
    )
    for t in doctest.DocTestFinder(exclude_empty=True).find(mod, name=modname):
        if t.examples:
            assert runner.run(t).failed == 0, f"{t.name}: doctest failures"


def test_public_api_has_examples():
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics import harm_n_ndim_le

    for fn in (biem, plane_wave, create_from_branching_types, harm_n_ndim_le):
        assert ">>>" in (fn.__doc__ or ""), f"{fn.__name__} lost its doctest"
