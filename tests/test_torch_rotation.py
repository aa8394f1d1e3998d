"""The rotation D and the scale-compensated coaxial factor against the JAX
package, and D's chunked build, on the CPU (split from
test_torch_translation.py so the test workers share them; tolerances as
there)."""

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
from biem_helmholtz_sphere_tpu_torch.translation import (
    coaxial_scaled,
    rotation_matrix,
)
from biem_helmholtz_sphere_tpu_torch.translation import _rotation
from biem_helmholtz_sphere_tpu_torch.translation._rotation import _rot_tables, rotation_blocks

from test_torch_translation import (  # noqa: F401 (fixtures)
    _directions,
)


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


@pytest.mark.parametrize("btype,n_end", [("ba", 6), ("bba", 5)])
def test_rotation_blocks_chunked_equals_all_at_once(btype, n_end, monkeypatch):
    """K3 over chunks of directions (the budget made small, so that two
    directions make a chunk) equals K3 over all of them at once (1e-14 of
    |D| ~ 1 in float64), on a batch of [3, 3] directions."""
    rng = np.random.default_rng(12)
    c = create_from_branching_types(btype)
    t_hat = torch.as_tensor(_directions(rng, c.c_ndim, 6).reshape(3, 3, -1))
    q_num, h_num = _rot_tables(c, n_end)[1].shape
    monkeypatch.setattr(_rotation, "_ROT_BYTES", 1 << 60)
    groups, ref = rotation_blocks(c, t_hat, n_end)
    per_dir = _rotation._ROT_TEMPS * q_num * h_num * 16
    monkeypatch.setattr(_rotation, "_ROT_BYTES", 2 * per_dir + 1)
    groups_c, got = rotation_blocks(c, t_hat, n_end)
    assert groups_c == groups
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[:2] == (3, 3)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-14)
