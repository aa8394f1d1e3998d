"""Parity of the port's special functions, harmonics and coordinates with
the JAX package, on the CPU in float64, on the same numpy inputs.

Tolerances: the two packages run the same recurrences in a different
operation order (eager torch loops vs lax.scan), so values agree to a few
ulps times the recurrence depth; 1e-12 relative covers n_end <= 24.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import coords as jcoords
from biem_helmholtz_sphere_tpu import harmonics as jharm
from biem_helmholtz_sphere_tpu import special as jspecial
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.special._family import (
    spherical_h_scaled as j_h_scaled,
    spherical_jh_scaled as j_jh_scaled,
)
from biem_helmholtz_sphere_tpu_torch import coords, harmonics, special
from biem_helmholtz_sphere_tpu_torch.harmonics._eval import _int_powers

F64 = dict(dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("btype,n_end", [("ba", 7), ("bba", 4), ("caa", 4), ("a", 5)])
def test_basis_matches_jax(btype, n_end):
    jb = jharm.basis(jcoords.create_from_branching_types(btype), n_end)
    tb = harmonics.basis(coords.create_from_branching_types(btype), n_end)
    assert tb.num == jb.num
    np.testing.assert_array_equal(tb.n_root, jb.n_root)
    np.testing.assert_array_equal(tb.conj_index, jb.conj_index)
    assert tb.node_jobs == jb.node_jobs
    for nid, idx in jb.node_job_index.items():
        np.testing.assert_array_equal(tb.node_job_index[nid], idx)
    assert harmonics.assume_n_end_from_num(
        coords.create_from_branching_types(btype), jb.num
    ) == n_end


@pytest.mark.parametrize("btype,n_end", [("ba", 9), ("bba", 5)])
def test_harmonics_matches_jax(btype, n_end):
    rng = np.random.default_rng(11)
    jc = jcoords.create_from_branching_types(btype)
    tc = coords.create_from_branching_types(btype)
    x = rng.normal(size=(jc.c_ndim, 17))
    jsph = jcoords.from_cartesian(jc, x)
    tsph = coords.from_cartesian(tc, _t(x))
    for key, v in jsph.items():
        np.testing.assert_allclose(tsph[key].numpy(), np.asarray(v), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        coords.to_cartesian(tc, tsph).numpy(), np.asarray(jcoords.to_cartesian(jc, jsph)),
        rtol=1e-13, atol=1e-13,
    )
    y_j = tonp(jharm.harmonics(jc, jsph, n_end))
    y_t = harmonics.harmonics(tc, tsph, n_end).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12)


def test_c_nodes_not_ported():
    """'c' nodes raised until the port took them; they now match the JAX
    package (tests/test_torch_ctrees.py holds more trees and degrees)."""
    tc, jc = coords.create_from_branching_types("caa"), jcoords.create_from_branching_types("caa")
    x = np.ones((4, 2))
    x[1, 1] = -0.5
    got = harmonics.harmonics(tc, coords.from_cartesian(tc, _t(x)), 3).numpy()
    ref = tonp(jharm.harmonics(jc, jcoords.from_cartesian(jc, x), 3))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_quadrature_rules_match_jax():
    for q, a in [(5, 0.0), (9, 1.5), (33, 0.0)]:
        x_t, w_t = special.gauss_jacobi(q, a, a)
        x_j, w_j = jspecial.gauss_jacobi(q, a, a)
        np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-15)
        np.testing.assert_allclose(w_t, w_j, rtol=1e-14)
    for btype in ("ba", "bba"):
        s_t, w_t = harmonics.sphere_quadrature(coords.create_from_branching_types(btype), 10)
        s_j, w_j = jharm.sphere_quadrature(jcoords.create_from_branching_types(btype), 10)
        np.testing.assert_allclose(w_t, w_j, rtol=1e-14)
        for key in s_j:
            np.testing.assert_allclose(s_t[key], s_j[key], rtol=1e-14, atol=1e-15)


def test_orthonormal_jacobi_and_int_powers_match_jax():
    x = np.linspace(-0.99, 0.99, 13)
    t = special.orthonormal_jacobi_table(_t(x), 20, [0.0, 2.0, 3.5], [0.0, 2.0, 1.0])
    j = jspecial.orthonormal_jacobi_table(x, 20, [0.0, 2.0, 3.5], [0.0, 2.0, 1.0])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)
    p = _int_powers(_t(x), 7).numpy()
    np.testing.assert_allclose(p, x[:, None] ** np.arange(8), rtol=1e-15)


# z straddles the n <= |z| switch between upward and Miller-downward j
Z = np.array([0.3, 2.5, 9.0, 17.5, 40.0])


@pytest.mark.parametrize("d", [3, 5])
def test_spherical_jh_scaled_matches_jax(d):
    n_end = 24
    out_t = special.spherical_jh_scaled(d, n_end, _t(Z))
    out_j = j_jh_scaled(d, n_end, Z)
    for (mt, et), (mj, ej) in zip(out_t, out_j):
        # compare the represented values mant * exp(e): both packages
        # normalize |mant| to ~1, so mantissas and exponents agree too
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12, atol=1e-11)
        np.testing.assert_allclose(mt.numpy(), tonp(mj), rtol=1e-11, atol=1e-11)
    hm_t, he_t = special.spherical_h_scaled(d, n_end, _t(Z))
    hm_j, he_j = j_h_scaled(d, n_end, Z)
    np.testing.assert_allclose(he_t.numpy(), np.asarray(he_j), rtol=1e-12, atol=1e-11)
    np.testing.assert_allclose(hm_t.numpy(), tonp(hm_j), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("d", [3, 5])
def test_spherical_jh_all_matches_jax(d):
    z = np.concatenate([[0.0], Z])
    out_t = special.spherical_jh_all(d, 16, _t(z))
    out_j = jspecial.spherical_jh_all(d, 16, z)
    for a_t, a_j in zip(out_t, out_j):
        a_t, a_j = a_t.numpy(), tonp(a_j)
        fin = np.isfinite(a_j)
        np.testing.assert_array_equal(np.isfinite(a_t), fin)
        np.testing.assert_allclose(a_t[fin], a_j[fin], rtol=1e-11, atol=1e-300)


def test_small_argument_seeds_use_the_series():
    """|z| < 1e-4 takes the series for j0, j1 and the closed form for h.
    The JAX package substitutes z = 1 into its j series and its h seeds
    there (j0(5e-5) = 0.8417), so the port is held to the closed forms."""
    z = np.array([5e-5, 2e-4])
    j, _, h, _ = special.spherical_jh_all(3, 3, torch.tensor(z, **F64))
    np.testing.assert_allclose(j[:, 0].real.numpy(), np.sin(z) / z, rtol=1e-15)
    np.testing.assert_allclose(j[:, 1].real.numpy(), z / 3 * (1 - z * z / 10), rtol=1e-12)
    np.testing.assert_allclose(j[:, 2].real.numpy(), z * z / 15, rtol=1e-8)
    np.testing.assert_allclose(h[:, 0].numpy(), -1j * np.exp(1j * z) / z, rtol=1e-15)
    hm, he = special.spherical_h_scaled(3, 3, torch.tensor(z, **F64))
    h_s = (hm * torch.exp(he)).numpy()
    np.testing.assert_allclose(h_s[:, 1], -np.exp(1j * z) * (z + 1j) / z**2, rtol=1e-14)


def test_even_dimension_raises():
    """Even d is ported (the base-2 family; tests/test_torch_even_d.py holds
    it to the JAX package), so it no longer raises; a dimension below 2
    still does."""
    with pytest.raises(ValueError, match="dimension must be >= 2"):
        special.spherical_jh_scaled(1, 5, _t(Z))
    for mant, e in special.spherical_jh_scaled(4, 5, _t(Z)):
        assert bool(torch.isfinite(mant).all()) and bool(torch.isfinite(e).all())


def test_port_imports_without_jax():
    """The port never imports jax: importing it with jax unavailable works."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import biem_helmholtz_sphere_tpu_torch as p\n"
        "from biem_helmholtz_sphere_tpu_torch.biem import _core, _eval, _eval_fused\n"
        "from biem_helmholtz_sphere_tpu_torch.ops import kernels, gmres\n"
        "from biem_helmholtz_sphere_tpu_torch import convert\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print(p.biem.__name__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "biem"


# the K5 kernel's oracles (the plain versions) on values, |z| from 1e-3 to 60
Z_WIDE = np.geomspace(1e-3, 60.0, 23)


def _value_rel(mant_t, e_t, mant_j, e_j, keep=True):
    """Largest entrywise relative error of mant_t exp(e_t) against
    mant_j exp(e_j), over the entries in `keep`."""
    got = mant_t * np.exp(e_t - e_j)
    return np.max((np.abs(got - mant_j) / np.abs(mant_j))[np.broadcast_to(keep, got.shape)])


def _keep(d, name, n_end):
    """The entries compared: all but j_0' of d >= 5 at |z| < 0.5.  There
    j_0' = -z/15 + ... is the difference of O(1) terms: both packages lose
    ~15/|z|^2 ulps of it (~7 of the 16 digits at |z| = 1e-3).  Every other
    order is held to 1e-12 over the whole |z| range."""
    keep = np.ones((len(Z_WIDE), n_end), bool)
    if d > 3 and name == "jp":
        keep[:, 0] = Z_WIDE >= 0.5
    return keep


@pytest.mark.parametrize("d", [3, 5])
def test_k5_plain_versions_match_jax_on_values(d):
    """spherical_jh_scaled, spherical_h_scaled and spherical_jh_all (the
    kernel's plain versions on CPU tensors) against the JAX package."""
    n_end = 20
    z = _t(Z_WIDE)
    names = ("j", "jp", "h", "hp")
    for name, (mt, et), (mj, ej) in zip(names, special.spherical_jh_scaled(d, n_end, z),
                                        j_jh_scaled(d, n_end, Z_WIDE)):
        assert _value_rel(mt.numpy(), et.numpy(), tonp(mj), np.asarray(ej),
                          _keep(d, name, n_end)) <= 1e-12, name
    hm, he = special.spherical_h_scaled(d, 2 * n_end - 1, z)
    hm_j, he_j = j_h_scaled(d, 2 * n_end - 1, Z_WIDE)
    assert _value_rel(hm.numpy(), he.numpy(), tonp(hm_j), np.asarray(he_j)) <= 1e-12
    for name, a_t, a_j in zip(names, special.spherical_jh_all(d, n_end, z),
                              jspecial.spherical_jh_all(d, n_end, Z_WIDE)):
        a_t, a_j = a_t.numpy(), tonp(a_j)
        fin = np.isfinite(a_j)
        np.testing.assert_array_equal(np.isfinite(a_t), fin)
        cmp = fin & _keep(d, name, n_end)
        np.testing.assert_allclose(a_t[cmp], a_j[cmp], rtol=1e-12, atol=0, err_msg=name)
