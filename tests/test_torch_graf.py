"""The 2D Graf translation and its KG kernel's plain version, against the
JAX package on the CPU with the same numpy inputs.

Tolerances are relative to the largest entry of each (|m'|, |m|) degree
block: both packages evaluate the same closed form (K5's d = 2 family, a
gather, an i-power and a phase) in another operation order.  Float64:
1e-12 on the unscaled table; 2e-11 on the scaled and folded ones at k|t|
up to 11.4 + 1.2i, which is the d = 2 family's own float64 accuracy there:
both packages' h_n (n < 23) at z = (1.9 + 0.2i) 6 are within 3.0e-11 and
3.4e-11 of scipy's, and 1.5e-11 apart (at real z = 6.4, 3.1e-12 and
3.6e-12).
Float32 (the port) against float64 (JAX): 1e-5, on offsets that are exact
in float32.  The JAX package's unscaled matrices are committed in
tests/golden/test_torch_graf.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

import _jax_golden
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation import translation_matrix as j_translation_matrix
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.graf import _graf_fold_plain, graf_fold
from biem_helmholtz_sphere_tpu_torch.special import spherical_h_scaled, spherical_jh_all
from biem_helmholtz_sphere_tpu_torch.translation import translation_matrix
from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_node_m


TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_SCALED = {torch.float64: 2e-11, torch.float32: 1e-5}
KS = {"real": 1.7, "complex": 1.7 + 0.3j}


def _offsets(rng, n=5):
    """[2, n] offsets of length 2.5-6 in every quadrant, and one on an axis,
    rounded to float32 so that both packages see the same offsets in either
    dtype (a float32 angle's own rounding, times |m - m'| ~ 46, is ~1e-5)."""
    r = rng.uniform(2.5, 6.0, size=n)
    phi = rng.uniform(-np.pi, np.pi, size=n)
    t = np.stack([r * np.cos(phi), r * np.sin(phi)])
    return np.concatenate([t, [[0.0], [-3.0]]], axis=1).astype(np.float32).astype(np.float64)


def _block_rel_err(got, ref, m_out, m_in):
    """The largest error of each (|m'|, |m|) block relative to that block's
    largest entry of ref."""
    worst = 0.0
    for a in np.unique(np.abs(m_out)):
        for b in np.unique(np.abs(m_in)):
            rows, cols = np.abs(m_out) == a, np.abs(m_in) == b
            g, r = got[..., rows, :][..., cols], ref[..., rows, :][..., cols]
            scale = np.abs(r).max()
            worst = max(worst, float(np.abs(g - r).max() / scale))
    return worst


def _j_k(k):
    return C.of(jnp.asarray(k)) if isinstance(k, complex) else jnp.asarray(k)


def _t_k(k, rdt):
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    return torch.tensor(k, dtype=cdt if isinstance(k, complex) else rdt)


GRAF_CASES = [("SR", 6, 6), ("SR", 5, 8), ("RR", 6, 4)]


def jax_golden():
    """The JAX package's 2D translation matrices that test_graf_2d_matches_jax
    reads (its (R|R) compiles for a minute per k type on the CPU)."""
    t = _offsets(np.random.default_rng(2))
    return {f"{kind}-{n_end}-{n_add}-{kname}": tonp(j_translation_matrix(
                j_tree("a"), jnp.asarray(t), n_end, _j_k(KS[kname]), kind=kind, n_end_add=n_add))
            for kind, n_end, n_add in GRAF_CASES for kname in KS}


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_graf")


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kname", ["real", "complex"])
@pytest.mark.parametrize("kind,n_end,n_add", GRAF_CASES)
def test_graf_2d_matches_jax(jax_values, kind, n_end, n_add, kname, rdt):
    """translation_matrix in 2D (Graf's closed form through KG's
    zero-exponent mode) against the JAX package, with n_end_add (the JAX
    values committed: `jax_golden`)."""
    t = _offsets(np.random.default_rng(2))
    k = KS[kname]
    c = create_from_branching_types("a")
    got = translation_matrix(c, torch.tensor(t, dtype=rdt), n_end, _t_k(k, rdt), kind=kind,
                             n_end_add=n_add).numpy()
    ref = jax_values[f"{kind}-{n_end}-{n_add}-{kname}"]
    assert got.shape == ref.shape == (t.shape[1], 2 * n_end - 1, 2 * n_add - 1)
    assert _block_rel_err(got, ref, _a_node_m(c, n_end), _a_node_m(c, n_add)) <= TOL[rdt]


def test_graf_fold_zero_exponent_mode_is_graf_2d():
    """KG's zero-exponent mode on per-k angles is translation_matrix's 2D
    table at each k's own offsets; the fold with zero exponents is the
    same table."""
    rng = np.random.default_rng(6)
    n_end, n_k = 7, 3
    t = rng.normal(size=(2, n_k, 4)) * 4.0
    k = torch.tensor([0.9, 1.3, 2.2], dtype=torch.float64)
    c = create_from_branching_types("a")
    ref = translation_matrix(c, torch.tensor(t), n_end, k[:, None])
    r = torch.tensor(np.hypot(t[0], t[1]))
    theta = torch.tensor(np.arctan2(t[1], t[0]))
    n_mu = 2 * n_end - 1
    _, _, hf, _ = spherical_jh_all(2, n_mu, k[:, None] * r)
    m = torch.tensor(_a_node_m(c, n_end))
    assert torch.equal(graf_fold(hf, theta, m, m), ref)
    hm, he = spherical_h_scaled(2, n_mu, k[:, None] * r)
    zero = torch.zeros(n_k, 2 * n_end - 1, dtype=torch.float64)
    folded = _graf_fold_plain(hm, he, theta, m, m, zero, zero)
    assert float((folded - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_graf_fold_checks_its_arguments():
    tab = torch.zeros(2, 3, 5, dtype=torch.complex128)
    m = torch.tensor([0, -1, 1])
    theta = torch.zeros(1, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not match"):
        graf_fold(tab, torch.zeros(2, 4, dtype=torch.float64), m, m)
    with pytest.raises(ValueError, match="do not match"):  # a fold needs all three
        graf_fold(tab, theta, m, m, e_tab=tab.real)
    with pytest.raises(ValueError, match="do not reach"):  # |m - m'| up to 3 needs 4 orders
        graf_fold(tab[..., :3], theta, torch.tensor([0, -1, 1, -2, 2]), m)
    assert graf_fold(tab, theta, m, m).shape == (2, 3, 3, 3)
