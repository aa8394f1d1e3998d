"""The scale-compensated 2D Graf table and KG's plain fold against the JAX
package, on the CPU (split from test_torch_graf.py so the test workers
share them; tolerances as there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._scaled import graf_2d_scaled as j_graf_2d_scaled
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.translation import sr_scaled
from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_node_m
from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
    graf_2d_folded,
    graf_2d_scaled,
)

from test_torch_graf import (  # noqa: F401 (fixtures)
    KS,
    TOL_SCALED,
    _block_rel_err,
    _j_k,
    _offsets,
    _t_k,
)


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kname", ["real", "complex"])
def test_graf_2d_scaled_matches_jax(kname, rdt):
    """graf_2d_scaled (and sr_scaled's 2D dispatch) as mant * exp(S)
    against the JAX package's, past the float32 overflow of h_n: n_end = 24
    at k|t| ~ 4-10 (|h_46(4)| ~ 1e46)."""
    t = _offsets(np.random.default_rng(3))
    k, n_end = KS[kname], 24
    c = create_from_branching_types("a")
    t_t = torch.tensor(t, dtype=rdt)
    mant, s_mat = graf_2d_scaled(c, None, n_end, _t_k(k, rdt), t_cart=t_t)
    mant2, s_mat2 = sr_scaled(c, None, n_end, _t_k(k, rdt), t_cart=t_t)
    assert torch.equal(mant, mant2) and torch.equal(s_mat, s_mat2)
    jm, je = j_graf_2d_scaled(j_tree("a"), j_from_cartesian(j_tree("a"), jnp.asarray(t)),
                              n_end, _j_k(k))
    jm, je = tonp(jm), np.asarray(je)
    assert bool(torch.isfinite(mant).all())
    # compare mant * exp(S - S_ref): both sides finite in float64
    got = mant.to(torch.complex128).numpy() * np.exp(s_mat.double().numpy() - je)
    m = _a_node_m(c, n_end)
    assert _block_rel_err(got, jm, m, m) <= TOL_SCALED[rdt]
    if rdt == torch.float64:
        assert np.abs(s_mat.numpy() - je).max() <= TOL_SCALED[rdt] * np.abs(je).max()


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kname", ["real", "complex"])
def test_graf_fold_plain_matches_jax_fold(kname, rdt):
    """KG's plain version with a nonzero fold (each k its own row and column
    exponents, the offsets' angles shared) against the JAX package's
    graf_2d_scaled followed by the fold of its offset-table route."""
    rng = np.random.default_rng(4)
    t = _offsets(rng)
    n_end, n_k = 12, 2
    ks = np.array([1.1, 1.9]) + (0.2j if kname == "complex" else 0.0)
    h = 2 * n_end - 1
    # exponents of the size the ball-max fold carries (|e| up to ~60)
    e_r = -np.abs(rng.normal(size=(n_k, h))) * 20.0
    e_b = rng.normal(size=(n_k, h)) * 10.0
    c = create_from_branching_types("a")
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    k_t = torch.tensor(ks, dtype=cdt if kname == "complex" else rdt)
    got = graf_2d_folded(c, torch.tensor(t, dtype=rdt), n_end, k_t,
                         torch.tensor(e_r, dtype=rdt), torch.tensor(e_b, dtype=rdt)).numpy()
    j_k = C.of(jnp.asarray(ks))[:, None] if kname == "complex" else jnp.asarray(ks)[:, None]
    jm, je = j_graf_2d_scaled(j_tree("a"), j_from_cartesian(j_tree("a"), jnp.asarray(t)),
                              n_end, j_k)
    ref = tonp(jm) * np.exp(e_r[:, None, :, None] + np.asarray(je) + e_b[:, None, None, :])
    assert got.shape == ref.shape == (n_k, t.shape[1], h, h)
    m = _a_node_m(c, n_end)
    assert _block_rel_err(got, ref, m, m) <= TOL_SCALED[rdt]
