"""The even-d special functions (the base-2 family and its cylinder seeds)
against the JAX package and scipy.special, on the CPU.

z covers both sides of the seam |z| = 14 between the ascending series and
the Hankel asymptotics, Im z up to 1, and, at n_end = 40, orders whose h_n
overflow float32 (the scaled forms carry them as mantissa x exponent).

Tolerances: `cyl_jh01` is the JAX package's series and expansions in the
same Horner order (1e-14 relative to its eager evaluation; 1e-10 of
scipy.special in float64, whose series near the seam cancels from ~1e5).
The families against the JAX package in float64: 5e-12 away from the seam
(the same recurrences in another order), 5e-10 at |z| = 13.9 and 14.1,
where the JAX package's compiled series rounds differently from its eager
one by up to 2e-11 and the recurrences carry that.  Float32 against the
JAX package's float64: 2e-4 on the aligned scaled mantissas (measured
7e-5) and 2e-5 on the unscaled values, relative above 1 (measured 5e-6).
The scaled values are compared as mant_port exp(e_port - e_jax) against
mant_jax, both normalised to max(|re|, |im|) = 1.
"""

from functools import lru_cache

import numpy as np
import pytest
import scipy.special as sp
import torch

from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.special import _family as j_family
from biem_helmholtz_sphere_tpu_torch import special


OFF_SEAM = np.array([0.3, 2.5, 9.0, 17.5, 40.0])
SEAM = np.array([13.9, 14.1])
Z = np.concatenate([OFF_SEAM, SEAM])
Z = np.concatenate([Z, Z + 0.5j, Z + 1.0j])
AT_SEAM = np.isin(np.round(Z.real, 6), SEAM)
CDT = {"float64": (np.complex128, torch.complex128), "float32": (np.complex64, torch.complex64)}


def _c(z):
    return C(np.array(z.real), np.array(z.imag))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cyl_jh01_against_scipy(dtype):
    """Real z in [0.5, 30] through the seam; float32 inputs keep float32
    rounding only (the seeds are evaluated in float64)."""
    z = np.linspace(0.5, 30.0, 119)
    got = special.cyl_jh01(torch.tensor(z.astype(np.float32 if dtype == "float32" else z.dtype)))
    assert got[0].dtype == CDT[dtype][1]
    zr = z.astype(np.float32).astype(np.float64) if dtype == "float32" else z
    ref = (sp.jv(0, zr), sp.jv(1, zr), sp.hankel1(0, zr), sp.hankel1(1, zr))
    tol = 1e-6 if dtype == "float32" else 1e-10
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol)


def _scaled_close(got, ref, tol_off, tol_seam):
    """Aligned mantissas: mant_g exp(e_g - e_r) against mant_r."""
    (mg, eg), (mr, er) = got, ref
    mg, eg = mg.numpy().astype(np.complex128), eg.numpy().astype(np.float64)
    mr, er = tonp(mr), np.asarray(er)
    assert np.isfinite(mg).all() and np.isfinite(eg).all()
    d = np.abs(mg * np.exp(eg - er) - mr)
    assert d[~AT_SEAM].max() <= tol_off
    assert d[AT_SEAM].max() <= tol_seam


TOL_SCALED = {"float64": (5e-12, 5e-10), "float32": (2e-4, 2e-4)}
N_END = 40


@lru_cache(maxsize=None)
def _jax_scaled(d):
    """The JAX package's scaled j, j', h, h' at Z, n_end = 40 (one compile
    per d, shared by both dtypes and by the h-only comparison: h_n does not
    depend on n_end, and h-only is the same upward pass)."""
    return j_family.spherical_jh_scaled(d, N_END, _c(Z))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [2, 4, 6])
def test_spherical_jh_scaled_even_d(d, dtype):
    got = special.spherical_jh_scaled(d, N_END, torch.tensor(Z.astype(CDT[dtype][0])))
    for g, r in zip(got, _jax_scaled(d)):
        assert g[0].shape == (len(Z), N_END)
        _scaled_close(g, r, *TOL_SCALED[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [2, 4, 6])
def test_spherical_h_scaled_even_d(d, dtype):
    z = torch.tensor(Z.astype(CDT[dtype][0]))
    hm, he = _jax_scaled(d)[2]
    for n_end in (1, N_END):
        got = special.spherical_h_scaled(d, n_end, z)
        _scaled_close(got, (hm[..., :n_end], he[..., :n_end]), *TOL_SCALED[dtype])
