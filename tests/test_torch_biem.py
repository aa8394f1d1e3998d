"""The port's slice end to end: biem() -> factored matvec -> GMRES -> uscat,
against the JAX package on the CPU in float64 with the same inputs.

The JAX side runs biem(..., solver="matfree", stable=True), the route the
port implements.  Tolerances: both solves stop at the float64 GMRES
tolerance 1e-11 (relative preconditioned residual), so densities agree to
~1e-9 relative; evaluation of one density is the same arithmetic in
another order (1e-12 of the largest value).  The JAX solves are
committed in tests/golden/test_torch_biem.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu_torch import BIEMResultCalculator, biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.gmres import _gmres_cgs2, gmres_solve_op

N_END = 4
KS = np.array([1.3, 1.7])
F64 = dict(dtype=torch.float64)
# near-field points: two outside every sphere, one inside sphere 5 (NaN)
X_NEAR = np.array([[0.0, 0.3, 9.0, -1.9], [0.0, 2.1, -1.0, -2.1], [0.0, 0.5, 1.5, 0.2]])
X_FAR = np.array([[1.0, 0.0, 0.6], [0.0, 0.6, 0.0], [0.0, 0.8, 0.8]])


def _lattice(n_side=4, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _direction(n_k):
    return np.broadcast_to(np.array([1.0, 0.0, 0.0])[:, None], (3, n_k)).copy()


def _jax_lattice():
    """The JAX package's solve of the 4x4 lattice at two k (factored route)."""
    centers = np.broadcast_to(_lattice(), (len(KS), 16, 3))
    uin, _ = j_plane_wave(k=KS, direction=_direction(len(KS)))
    calc = j_biem(
        j_tree("ba"), centers=centers, radii=np.ones((len(KS), 16)), k=KS,
        n_end=N_END, uin=uin, solver="matfree", stable=True,
    )
    return {
        "density": calc.density.to_numpy(),
        "near": calc.uscat(X_NEAR).to_numpy(),
        "far": calc.uscat(X_FAR, far_field=True).to_numpy(),
        "per_ball": calc.uscat(X_NEAR[:, :2], per_ball=True).to_numpy(),
        "relres": np.asarray(calc.relres),
    }


@pytest.fixture(scope="module")
def jax_lattice():
    """`_jax_lattice`, committed (`jax_golden`)."""
    values = _jax_golden.load("test_torch_biem")
    return {key[len("lattice "):]: v for key, v in values.items() if key.startswith("lattice ")}


def _port_lattice():
    uin, _ = plane_wave(k=torch.tensor(KS), direction=torch.tensor(_direction(len(KS))))
    return biem(
        create_from_branching_types("ba"),
        centers=torch.tensor(np.broadcast_to(_lattice(), (len(KS), 16, 3)).copy()),
        radii=torch.ones(len(KS), 16, **F64), k=torch.tensor(KS), n_end=N_END,
        uin=uin, solver="matfree", stable=True,
    )


def _assert_field(got, ref, rel=1e-12):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=rel * np.abs(ref[~nan]).max())


def test_lattice_density_and_uscat_match_jax(jax_lattice):
    calc = _port_lattice()
    d_ref = jax_lattice["density"]
    d = calc.density.numpy()
    assert d.shape == d_ref.shape == (len(KS), 16, N_END * N_END)
    assert np.abs(d - d_ref).max() <= 1e-9 * np.abs(d_ref).max()
    assert float(calc.relres.max()) <= 1e-11
    assert calc.iters.shape == (len(KS),)
    _assert_field(calc.uscat(torch.tensor(X_NEAR)).numpy(), jax_lattice["near"], 1e-9)
    _assert_field(calc.uscat(torch.tensor(X_FAR), far_field=True).numpy(),
                  jax_lattice["far"], 1e-9)


def test_uscat_on_a_jax_density(jax_lattice):
    """Evaluation parity apart from solve parity: the port evaluates the
    density the JAX package solved."""
    calc = BIEMResultCalculator.from_numpy(
        create_from_branching_types("ba"), N_END,
        np.broadcast_to(_lattice(), (len(KS), 16, 3)), np.ones((len(KS), 16)), KS,
        None, jax_lattice["density"], device="cpu",
    )
    _assert_field(calc.uscat(torch.tensor(X_NEAR)).numpy(), jax_lattice["near"])
    _assert_field(calc.uscat(torch.tensor(X_FAR), far_field=True).numpy(),
                  jax_lattice["far"])
    _assert_field(calc.uscat(torch.tensor(X_NEAR[:, :2]), per_ball=True).numpy(),
                  jax_lattice["per_ball"])


def _two_spheres(dtype, n_end, t=4.0, k=1.0):
    f = dict(dtype=dtype)
    uin, _ = plane_wave(k=torch.tensor(k, **f), direction=torch.tensor([1.0, 0.0, 0.0], **f))
    return biem(
        create_from_branching_types("ba"),
        centers=torch.tensor([[0.0, t / 2, 0.0], [0.0, -t / 2, 0.0]], **f),
        radii=torch.ones(2, **f), k=torch.tensor(k, **f), n_end=n_end, uin=uin,
        solver="matfree", stable=True,
    )


def test_readme_golden_through_the_port():
    """The reference README value, 6 decimal places, on the factored route."""
    u = complex(_two_spheres(torch.float64, 6).uscat(torch.zeros(3, 1, **F64))[0])
    assert (round(u.real, 6), round(u.imag, 6)) == (-0.741333, -0.669657)
    u32 = complex(_two_spheres(torch.float32, 6).uscat(torch.zeros(3, 1))[0])
    assert abs(u32 - u) < 1e-5


def test_float32_past_the_overflow_wall():
    """Two unit spheres at t = 4, k = 1, n_end = 24: the unscaled float32
    (S|R) overflows there (|h_42(4)| > 3.4e38); the scale-compensated
    port stays finite and within 1e-4 of its own float64."""
    c32 = _two_spheres(torch.float32, 24)
    assert bool(torch.isfinite(c32.density).all())
    u32 = complex(c32.uscat(torch.zeros(3, 1))[0])
    u64 = complex(_two_spheres(torch.float64, 24).uscat(torch.zeros(3, 1, **F64))[0])
    assert abs(u32 - u64) <= 1e-4


def test_density0_warm_start_cuts_iterations():
    c = create_from_branching_types("ba")
    centers = torch.tensor(_lattice(2, 4.0))

    def solve(k, dens0=None):
        uin, _ = plane_wave(k=torch.tensor(k, **F64), direction=torch.tensor([1.0, 0.0, 0.0]))
        return biem(c, centers=centers, radii=torch.ones(4, **F64), k=torch.tensor(k, **F64),
                    n_end=5, uin=uin, solver="matfree", stable=True, density0=dens0)

    cold = solve(2.0)
    warm = solve(2.0, cold.density)
    assert int(warm.iters) < int(cold.iters)
    assert float(warm.relres) <= 1e-11


def test_gmres_raises_on_a_nan_operator():
    """resid > target is False for NaN: the solver must raise instead of
    reporting a converged solve after one step, at every lag of the host's
    reads of the flag word (None: gmres_solve_op's own, 1 on the CPU)."""
    b = torch.ones(2, 8, dtype=torch.complex128)
    diag = torch.ones_like(b)
    for lag in (None, 2, 4, 8):
        def solve(mv, rhs):
            if lag is None:
                return gmres_solve_op(mv, diag, rhs)
            return _gmres_cgs2(mv, diag, rhs, 1e-11, 8, 20, None, lag=lag)

        with pytest.raises(FloatingPointError):
            solve(lambda x: x * float("nan"), b)
        with pytest.raises(FloatingPointError):
            solve(lambda x: x, b * float("nan"))


def test_gmres_matches_a_direct_solve():
    rng = np.random.default_rng(31)
    n = 40
    a = torch.tensor(np.eye(n) * 4 + rng.normal(size=(2, n, n)) * 0.3
                     + 1j * rng.normal(size=(2, n, n)) * 0.3)
    b = torch.tensor(rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    x, relres, iters = gmres_solve_op(lambda v: (a @ v[..., None])[..., 0], diag, b)
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(a, b).numpy(), rtol=0, atol=1e-9)
    assert float(relres.max()) <= 1e-11 and int(iters.min()) > 0
    _, _, iters0 = gmres_solve_op(lambda v: (a @ v[..., None])[..., 0], diag, b, x0=x)
    assert int(iters0.max()) <= 2


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


UNPORTED = ["triplet", "gumerov", "2d-tree", "c-tree", "lattice-64"]


def _unported_call(case):
    """(tree, direction, biem() keywords as numpy) of a case of
    test_unported_routes_raise."""
    tree = {"2d-tree": "a", "c-tree": "caa"}.get(case, "ba")
    d = {"a": 2, "ba": 3, "caa": 4}[tree]
    n_balls = {"lattice-64": 64}.get(case, 2)
    centers = np.zeros((n_balls, d))
    centers[:, 0] = 3.0 * np.arange(n_balls)
    direction = np.eye(d)[0]
    kw = dict(solver="matfree", stable=True)
    if case in ("triplet", "gumerov"):  # the plain dense route's translation
        kw = dict(solver="direct", stable=False, translational_coefficients_method=case)
    return tree, direction, dict(centers=centers, radii=np.ones(n_balls), k=np.asarray(1.0),
                                 n_end=3, **kw)


def jax_golden():
    """The JAX package's densities that test_unported_routes_raise reads
    (the 'caa', 2D and 64-sphere solves compile for half a minute to a
    minute each on the CPU) and its lattice solve (`_jax_lattice`)."""
    out = {}
    for case in UNPORTED:
        tree, direction, call = _unported_call(case)
        j_uin, _ = j_plane_wave(k=np.asarray(1.0), direction=direction)
        out[case] = j_biem(j_tree(tree), uin=j_uin, **call).density.to_numpy()
    out.update({f"lattice {key}": v for key, v in _jax_lattice().items()})
    return out


@pytest.mark.parametrize("case", UNPORTED)
def test_unported_routes_raise(case):
    """Each case raised NotImplementedError until the port took it; each
    now solves and must match the JAX package's solve of the same call
    (float64 GMRES tolerance 1e-11: densities within 1e-9; the JAX
    densities committed: `jax_golden`): "2d-tree" (a 2D pair on the
    offset-table route, KG) and "lattice-64" (64 spheres on a line, the
    lattice-FFT route), then "c-tree" (a 'caa' pair on the scaled
    offset-table route, KS in fold mode), "triplet" (the plain dense
    route's band-scan translation on 'ba', KS unscaled) and "gumerov" (the
    plain dense route's rotation + Gumerov-Duraiswami ladders on 'ba')."""
    tree, direction, call = _unported_call(case)
    uin, _ = plane_wave(k=torch.tensor(1.0, **F64), direction=torch.tensor(direction))
    got = biem(create_from_branching_types(tree), uin=uin,
               **{key: torch.tensor(v) if isinstance(v, np.ndarray) else v
                  for key, v in call.items()}).density.numpy()
    ref = _jax_golden.load("test_torch_biem")[case]
    n_balls, d = call["centers"].shape
    assert got.shape == ref.shape == (n_balls, {2: 5, 3: 9, 4: 14}[d])
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def test_entry_points_default_to_the_card(monkeypatch):
    """Without tensor inputs (numpy, Python numbers) the entry points run on
    the card and, with no CUDA, raise instead of running on the CPU; CPU
    tensors or device="cpu" are how a caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = create_from_branching_types("ba")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plane_wave(k=1.0, direction=np.array([1.0, 0.0, 0.0]))
    uin, _ = plane_wave(k=torch.tensor(1.0, **F64), direction=torch.tensor([1.0, 0.0, 0.0]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        biem(c, centers=np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]), radii=np.ones(2),
             k=1.0, n_end=3, uin=uin, solver="matfree", stable=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BIEMResultCalculator.from_numpy(c, 2, np.zeros((2, 3)), np.ones(2), 1.0, None,
                                        np.zeros((2, 4), np.complex128))
    calc = _two_spheres(torch.float64, 3)
    assert calc.density.device.type == "cpu"
    assert calc.uscat(torch.zeros(3, 1, **F64)).device.type == "cpu"
    assert uin(np.zeros((3, 1))).device.type == "cpu"
    cpu = BIEMResultCalculator.from_numpy(c, 2, np.zeros((2, 3)), np.ones(2), 1.0, None,
                                          np.zeros((2, 4), np.complex128), device="cpu")
    assert cpu.density.device.type == "cpu"
