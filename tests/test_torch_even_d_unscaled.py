"""The unscaled spherical functions of even dimension and the cylinder seeds
against the JAX package, on the CPU (split from test_torch_even_d.py so the
test workers share them; tolerances as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.special import _cyl as j_cyl
from biem_helmholtz_sphere_tpu.special import _family as j_family
from biem_helmholtz_sphere_tpu_torch import special

from test_torch_even_d import (  # noqa: F401 (fixtures)
    AT_SEAM,
    CDT,
    Z,
    _c,
)


def test_cyl_jh01_matches_jax():
    got = special.cyl_jh01(torch.tensor(Z))
    ref = j_cyl.cyl_jh01(_c(Z))
    for g, r in zip(got, ref):
        r = tonp(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-14, atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [2, 4, 6])
def test_spherical_jh_all_even_d(d, dtype):
    """Unscaled, with z = 0 (j_n(0) = c_d delta_n0, h infinite)."""
    z = np.concatenate([[0.0], Z])
    got = special.spherical_jh_all(d, 16, torch.tensor(z.astype(CDT[dtype][0])))
    ref = j_family.spherical_jh_all(d, 16, _c(z))
    seam = np.concatenate([[False], AT_SEAM])
    tol = {"float64": (5e-12, 5e-10), "float32": (2e-5, 2e-5)}[dtype]
    for g, r in zip(got, ref):
        g, r = g.numpy().astype(np.complex128), tonp(r)
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        d_rel = np.zeros(r.shape)
        d_rel[fin] = np.abs(g[fin] - r[fin]) / np.maximum(np.abs(r[fin]), 1.0)
        assert d_rel[~seam].max() <= tol[0]
        assert d_rel[seam].max() <= tol[1]
