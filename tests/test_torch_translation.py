"""Parity of the port's rotation and scale-compensated coaxial factors with
the JAX package, on the CPU in float64, on the same numpy inputs.

Tolerance: both packages build D by the same quadrature and X by the same
grouped band sum in a different operation order; entries agree to 1e-12
of the largest entry (|D| ~ 1, |mant| ~ 1).
"""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._rotation import (
    rotation_matrix as j_rotation_matrix,
)
from biem_helmholtz_sphere_tpu.translation._scaled import (
    coaxial_scaled as j_coaxial_scaled,
)
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.translation import (
    coaxial_scaled,
    rotation_matrix,
)


def _directions(rng, d, n):
    t = rng.normal(size=(n, d))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    # the Rodrigues edge cases: along, against and across the root axis
    e = np.zeros((3, d))
    e[0, -1], e[1, -1], e[2, 0] = 1.0, -1.0, 1.0
    return np.concatenate([t, e])


@pytest.mark.parametrize("btype,n_end", [("ba", 7), ("bba", 4)])
def test_rotation_matrix_matches_jax(btype, n_end):
    rng = np.random.default_rng(5)
    c_t, c_j = create_from_branching_types(btype), j_tree(btype)
    t_hat = _directions(rng, c_t.c_ndim, 5)
    d_t = rotation_matrix(c_t, torch.as_tensor(t_hat), n_end).numpy()
    d_j = tonp(j_rotation_matrix(c_j, t_hat, n_end))
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-12)
    # unitary
    eye = np.eye(d_t.shape[-1])
    np.testing.assert_allclose(d_t @ d_t.conj().swapaxes(-1, -2), eye + 0 * d_t, atol=1e-12)


def test_rotation_matrix_is_exactly_degree_block_diagonal():
    """Off the degree blocks D is exactly zero (the mask that keeps f32
    error from reaching 0.23), so packing it into blocks is exact."""
    c = create_from_branching_types("ba")
    n_end = 10
    t_hat = _directions(np.random.default_rng(3), 3, 4)
    d = rotation_matrix(c, torch.as_tensor(t_hat), n_end)
    n_root = basis(c, n_end).n_root
    off = torch.as_tensor(n_root[:, None] != n_root[None, :])
    assert bool((d[:, off] == 0).all())


def test_coaxial_scaled_matches_jax():
    c_t, c_j = create_from_branching_types("ba"), j_tree("ba")
    n_end = 8
    r = np.array([4.0, 4.0 * np.sqrt(2.0), 8.0])
    k = np.array([[1.3], [6.5]])
    m_t, s_t = coaxial_scaled(c_t, torch.as_tensor(r), n_end, torch.as_tensor(k))
    m_j, s_j = j_coaxial_scaled(c_j, r, n_end, k, kind="SR")
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-13, atol=1e-12)
    m_t, m_j = m_t.numpy(), tonp(m_j)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-12 * np.abs(m_j).max())


def test_coaxial_scaled_float32_past_overflow_is_finite():
    """At k t = 4 the plain float32 (S|R) overflows from n_end ~ 22; the
    scaled factor stays finite and matches float64 to float32 precision."""
    c = create_from_branching_types("ba")
    r, k = torch.tensor([4.0]), torch.tensor([[1.0]])
    m32, s32 = coaxial_scaled(c, r, 24, k)
    m64, s64 = coaxial_scaled(c, r.double(), 24, k.double())
    assert bool(torch.isfinite(m32).all()) and bool(torch.isfinite(s32).all())
    assert float(s64.max()) > 88.0  # beyond float32's exp range
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        m32.numpy(), m64.numpy(), rtol=0, atol=2e-5 * float(m64.abs().max())
    )
