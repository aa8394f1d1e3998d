"""The port's right-hand sides and incident fields against the JAX package,
on the CPU in float64 from the same numpy inputs.

The quadrature right-hand side (`_rhs_expansion`) of a tag-stripped plane
wave and of a point source; `point_source`, `shn1` and `sjn`; solves
through `biem()` with these fields; `max_memory`/`max_n_end`; several
leading batch axes.

Tolerances: the quadrature projection is the same sum in another order;
it sums integrand values of the size of the largest entry into entries
that fall like (k rho)^l / l!, so its rounding is held to 1e-12 of the
largest entry of each (k, sphere) row; the special functions are the same
recurrences (1e-12); solves stop at the float64 GMRES tolerance or are
direct (1e-10); the quadrature against the closed form is held to
1e-6 of the largest density entry, as tests/test_biem.py holds the JAX
package (the rule aliases degrees >= n_end).
"""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu import point_source as j_point_source
from biem_helmholtz_sphere_tpu.biem._core import _check_biem_inputs as j_check_inputs
from biem_helmholtz_sphere_tpu.biem._core import _rhs_expansion as j_rhs_expansion
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.harmonics import expand as j_expand
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.special._shn1 import shn1 as j_shn1
from biem_helmholtz_sphere_tpu.special._shn1 import sjn as j_sjn
from biem_helmholtz_sphere_tpu_torch import max_memory, max_n_end, plane_wave, point_source
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import expand
from biem_helmholtz_sphere_tpu_torch.special import shn1, sjn

F64 = dict(dtype=torch.float64)
KS = np.array([1.3, 2.1])
N_END = 8
CENTERS = np.array([[0.0, 2.2, 0.0], [0.0, -1.9, 0.0]])
RADII = np.array([1.0, 0.7])
DIRECTION = np.array([2.0, -1.0, 0.0])
SOURCE = np.array([0.5, 0.3, 3.5])


def _fields(kind, ks, lib):
    """(uin, uin_grad) of one kind for k [K] on either package, the plane
    wave's tags stripped."""
    if kind == "plane-wave":
        direction = np.broadcast_to(DIRECTION[:, None], (3, len(ks))).copy()
        if lib == "jax":
            u, g = j_plane_wave(k=ks, direction=direction)
        else:
            u, g = plane_wave(k=torch.tensor(ks), direction=torch.tensor(direction))
        return (lambda x, /: u(x)), (lambda x, /: g(x))
    source = np.broadcast_to(SOURCE[:, None], (3, len(ks))).copy()
    if lib == "jax":
        return j_point_source(k=ks, source=source)
    return point_source(k=torch.tensor(ks), source=torch.tensor(source))


def row_rel_err(got, ref):
    """Max over (k, sphere) rows of |got - ref| over the row's largest
    |ref|; got, ref [K, B, H]."""
    return float((np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max())


@pytest.mark.parametrize("kind", ["plane-wave", "point-source"])
@pytest.mark.parametrize("ab", [(1.0, 0.0), (0.0, 1.0), (1.0, 0.5)])
def test_rhs_expansion_matches_jax(kind, ab):
    n_k, nb = len(KS), len(RADII)
    alpha, beta = (np.full((n_k, nb), v) for v in ab)
    radii = np.broadcast_to(RADII, (n_k, nb)).copy()
    uj, gj = _fields(kind, KS, "jax")
    c_j = j_tree("ba")
    cen_j, rad_j, _, _, al_j, be_j = j_check_inputs(
        c_j, np.broadcast_to(CENTERS, (n_k, nb, 3)), radii, KS, None, alpha, beta)
    ref = tonp(j_rhs_expansion(c_j, N_END, cen_j, rad_j, al_j, be_j,
                               uj if ab[0] else None, gj if ab[1] else None, 1))
    u, g = _fields(kind, KS, "torch")
    got = _core._rhs_expansion(
        create_from_branching_types("ba"), N_END, torch.tensor(CENTERS), torch.tensor(radii),
        torch.tensor(alpha, dtype=torch.complex128), torch.tensor(beta, dtype=torch.complex128),
        u if ab[0] else None, g if ab[1] else None, (n_k,)).numpy()
    assert got.shape == ref.shape == (n_k, nb, N_END * N_END)
    assert row_rel_err(got, ref) <= 1e-12


def test_expand_matches_jax():
    """harmonics.expand of a function of the angles, with extra axes."""
    def f(sph):
        th, ph = sph[0], sph[1]
        return np.stack([np.cos(th) * np.exp(2j * ph), np.sin(th) ** 3], axis=-1)

    ref = tonp(j_expand(j_tree("ba"), f, 6))
    got = expand(create_from_branching_types("ba"), lambda s: torch.tensor(f(s)), 6).numpy()
    assert got.shape == ref.shape == (2, 36)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


def test_point_source_values_match_jax():
    ks = np.array([0.7, 1.3, 2.9])
    src = np.array([[0.5, 0.0, -1.0], [0.3, 2.0, 0.0], [3.5, 0.0, 0.4]])
    x = np.random.default_rng(5).normal(size=(3, 7, 3)) * 4.0
    uj, gj = j_point_source(k=ks, source=src)
    u, g = point_source(k=torch.tensor(ks), source=torch.tensor(src))
    for got, ref in ((u(torch.tensor(x)), uj(x)), (g(torch.tensor(x)), gj(x))):
        np.testing.assert_allclose(got.numpy(), tonp(ref), rtol=1e-12, atol=1e-14)
    u1, _ = point_source(k=torch.tensor(1.0, **F64), source=torch.tensor([0.0, 0.0, 3.0]))
    assert abs(complex(u1(torch.zeros(3, 1, **F64))[0])
               - (np.sin(3.0) / 3.0 - 1j * np.cos(3.0) / 3.0)) < 1e-14


@pytest.mark.parametrize("n", [0, 1, 5])
@pytest.mark.parametrize("d", [3, 5])
def test_shn1_sjn_match_jax(n, d):
    z = np.linspace(0.3, 25.0, 40)
    for fn, j_fn in ((shn1, j_shn1), (sjn, j_sjn)):
        for der in (False, True):
            got = fn(n, d, torch.tensor(z), derivative=der).numpy()
            ref = tonp(j_fn(n, d, z, derivative=der))
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


def test_point_source_raises_on_complex_k_and_bad_shapes():
    """Complex k is ported, so it no longer raises: h_0(k r) = -i e^{ikr}/(kr)
    at r = 3; bad shapes raise."""
    k = 1.0 + 0.1j
    uin, _ = point_source(k=torch.tensor(k, dtype=torch.complex128),
                          source=torch.tensor([0.0, 0.0, 3.0], **F64))
    u = complex(uin(torch.zeros(3, 1, **F64))[0])
    assert abs(u - (-1j) * np.exp(3j * k) / (3 * k)) <= 1e-14
    with pytest.raises(ValueError, match="source.ndim"):
        point_source(k=torch.tensor([1.0, 2.0], **F64), source=torch.zeros(3, **F64))
    with pytest.raises(ValueError, match="not broadcastable"):
        point_source(k=torch.tensor([1.0, 2.0], **F64), source=torch.zeros(3, 3, **F64))


def test_memory_model_parity():
    """tests/test_biem.py's cases, on the port."""
    assert max_memory(c_ndim=3, n_end=6, n_balls=2) == 4 * 36**2
    assert max_memory(c_ndim=4, n_end=3, n_balls=1) == (5 * 27) ** 2 * (11 * 216) * 16
    n = max_n_end(c_ndim=3, memory_limit=10**9, n_balls=2)
    assert max_memory(c_ndim=3, n_end=n, n_balls=2) <= 10**9
    assert max_memory(c_ndim=3, n_end=n + 1, n_balls=2) > 10**9
    from biem_helmholtz_sphere_tpu import max_memory as j_max_memory
    from biem_helmholtz_sphere_tpu import max_n_end as j_max_n_end

    for d, n_end, nb in ((2, 4, 3), (3, 32, 16), (5, 3, 2)):
        assert max_memory(c_ndim=d, n_end=n_end, n_balls=nb) == j_max_memory(
            c_ndim=d, n_end=n_end, n_balls=nb)
        assert max_n_end(c_ndim=d, memory_limit=10**8, n_balls=nb) == j_max_n_end(
            c_ndim=d, memory_limit=10**8, n_balls=nb)
