"""The port's offset-table matrix-free route against the JAX package, on the
CPU in float64 from the same numpy inputs.

The routing of the offset slots (`_pair_routing(radius_slots=False)`)
against the JAX package's one-hot tables; one matvec of the operator
(`_matfree_operator`: unscaled, or scale-compensated through an `sr_map`)
against the JAX package's; and the route through `biem()`.

Tolerances: one matvec is the same sums in another order; its entries
fall like (rho/t)^l with the degree l, so each (k, sphere, degree) block
is held to 1e-10 of its own largest entry.  Solves stop at the float64
GMRES tolerance 1e-11, so densities agree to ~1e-10 of the largest entry
(1e-9 against the JAX package, whose solve stops at its own tolerance).
The JAX package's operators and solve are committed in
tests/golden/test_torch_matfree.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.biem._core import _check_biem_inputs as j_check_inputs
from biem_helmholtz_sphere_tpu.biem._core import _matfree_operator as j_matfree_operator
from biem_helmholtz_sphere_tpu.biem._core import _pair_routing as j_pair_routing
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

F64 = dict(dtype=torch.float64)
KS = np.array([1.3, 2.1])


def _lattice(n_side=4, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _randc(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def degree_block_rel_err(got, ref, n_root):
    """Max over (k, sphere, degree l) blocks of |got - ref| relative to the
    block's largest |ref|; got, ref [K, B*H]."""
    h = len(n_root)
    d = np.abs(got - ref).reshape(got.shape[0], -1, h)
    r = np.abs(ref).reshape(d.shape)
    worst = 0.0
    for ell in np.unique(n_root):
        sel = n_root == ell
        worst = max(worst, float((d[..., sel].max(-1) / r[..., sel].max(-1)).max()))
    return worst


@pytest.mark.parametrize("geometry", ["lattice", "irregular"])
def test_offset_slot_routing_matches_jax_one_hot(geometry):
    """Slot o holds the o-th distinct offset in `_offsets`' order; each
    compacted lane sits at the JAX package's padded lane and routes the
    same source row into the same destination sphere."""
    centers = (_lattice(3) if geometry == "lattice"
               else np.random.default_rng(3).normal(size=(5, 3)) * 6.0)
    nb = len(centers)
    uniq_j, gth, sct, p_max = j_pair_routing(centers)
    rt = _core._pair_routing(centers, radius_slots=False)
    assert rt.p_max == p_max and rt.uniq_r is None and rt.g_max is None
    np.testing.assert_array_equal(rt.uniq, uniq_j)
    np.testing.assert_array_equal(rt.uniq, _core._offsets(centers)[0])
    used = np.nonzero(gth.any(axis=1))[0]
    np.testing.assert_array_equal(rt.lane, used)
    np.testing.assert_array_equal(gth[rt.lane, rt.src], 1.0)
    np.testing.assert_array_equal(sct[rt.dst, rt.lane], 1.0)
    np.testing.assert_array_equal(rt.dn, (rt.lane % (2 * p_max)) >= p_max)
    np.testing.assert_array_equal(np.diff(rt.slot_ptr), np.bincount(
        rt.lane // (2 * p_max), minlength=len(uniq_j)))
    assert len(rt.lane) == nb * (nb - 1)


_MV_CASES = {
    "unstable": (False, False, "lattice"),
    "stable-sr_map": (True, True, "lattice"),
    "unstable-nonuniform-radii": (False, False, "radii"),
    "stable-sr_map-nonuniform-radii": (True, True, "radii"),
}


def _mv_case(case):
    """(stable, sr_map, centers, radii, alpha, beta, eta, x) of a case of
    test_offset_table_matvec_matches_jax (n_end = 6)."""
    stable, with_map, radii_kind = _MV_CASES[case]
    n_k = len(KS)
    centers = _lattice(3, 3.0)
    nb = len(centers)
    rng = np.random.default_rng(41)
    radii = np.ones((n_k, nb)) if radii_kind == "lattice" else np.broadcast_to(
        rng.uniform(0.6, 1.2, size=nb), (n_k, nb)).copy()
    x = _randc(rng, (n_k, nb * 36))
    return (stable, (lambda s: s) if with_map else None, centers, radii,
            np.full((n_k, nb), 1.0), np.full((n_k, nb), 0.5), np.array([1.0, 0.7]), x)


def _bench_lattice_call():
    """(centers, direction) of test_bench_lattice_unscaled_matfree_matches_jax."""
    return (np.broadcast_to(_lattice(), (len(KS), 16, 3)),
            np.broadcast_to(np.array([1.0, 0.0, 0.0])[:, None], (3, len(KS))).copy())


def jax_golden():
    """The JAX package's values the tests read (each half a minute to a
    minute of compile on a cold CPU): the operator of each case of
    _MV_CASES (diag, one matvec) and the bench lattice's offset-table
    GMRES density."""
    out = {}
    for case in _MV_CASES:
        stable, sr_map, centers, radii, alpha, beta, eta, x = _mv_case(case)
        nb, n_k = len(centers), len(KS)
        _, rad, kc, eta_c, al, be = j_check_inputs(
            j_tree("ba"), np.broadcast_to(centers, (n_k, nb, 3)), radii, KS, eta, alpha, beta)
        mv_j, diag_j = j_matfree_operator(j_tree("ba"), 6, centers, rad, kc, eta_c, al, be,
                                          None, sr_map=sr_map, stable=stable)
        out[f"{case} diag"], out[f"{case} matvec"] = tonp(diag_j), tonp(mv_j(C.of(x)))
    centers, direction = _bench_lattice_call()
    uin_j, _ = j_plane_wave(k=KS, direction=direction)
    ref = j_biem(j_tree("ba"), centers=centers, radii=np.ones((len(KS), 16)), k=KS,
                 n_end=4, uin=uin_j, solver="matfree", stable=False)
    out["bench lattice density"] = tonp(ref.density)
    return out


@pytest.fixture(scope="module")
def jax_values():
    return _jax_golden.load("test_torch_matfree")


@pytest.mark.parametrize("case", list(_MV_CASES))
def test_offset_table_matvec_matches_jax(jax_values, case):
    stable, sr_map, centers, radii, alpha, beta, eta, x = _mv_case(case)
    n_end = 6
    diag_j, y_j = jax_values[f"{case} diag"], jax_values[f"{case} matvec"]
    mv, diag = _core._matfree_operator(
        create_from_branching_types("ba"), n_end, centers, torch.tensor(radii),
        torch.tensor(KS), torch.tensor(eta), torch.tensor(alpha, dtype=torch.complex128),
        torch.tensor(beta, dtype=torch.complex128), sr_map=sr_map, stable=stable)
    n_root = basis(create_from_branching_types("ba"), n_end).n_root
    assert degree_block_rel_err(diag.numpy(), diag_j, n_root) <= 1e-10
    assert degree_block_rel_err(mv(torch.tensor(x)).numpy(), y_j, n_root) <= 1e-10


def test_sr_map_sees_the_table_once():
    """sr_map receives the [K, NO, H, H] table once, at the build; the
    stable operator without it is the factored one."""
    centers = _lattice(2)
    seen = []

    def sr_map(s):
        seen.append(tuple(s.shape))
        return s

    args = (create_from_branching_types("ba"), 4, centers, torch.ones(2, 4, **F64),
            torch.tensor(KS), torch.ones(2, **F64), torch.ones(2, 4, dtype=torch.complex128),
            torch.zeros(2, 4, dtype=torch.complex128))
    mv, _ = _core._matfree_operator(*args, sr_map=sr_map, stable=True)
    x = torch.ones(2, 4 * 16, dtype=torch.complex128)
    y = mv(x)
    mv(x)
    n_off = len(_core._offsets(centers)[0])
    assert seen == [(2, n_off, 16, 16)]
    mv_f, _ = _core._matfree_operator(*args, stable=True)
    assert float((mv_f(x) - y).abs().max() / y.abs().max()) <= 1e-12


def _robin_kw(centers, radii, k=1.3, n_end=8, beta=0.5):
    f = dict(dtype=torch.float64)
    uin, uin_grad = plane_wave(k=torch.tensor(k, **f), direction=torch.tensor([1.0, 0.0, 0.0]))
    return dict(centers=torch.tensor(centers), radii=torch.tensor(radii), k=torch.tensor(k, **f),
                n_end=n_end, uin=uin, uin_grad=uin_grad if beta else None, alpha=1.0,
                beta=beta, eta=torch.tensor(1.0, **f))


@pytest.mark.parametrize("geometry", ["lattice-2x2", "irregular-3"])
def test_matfree_gmres_matches_direct(geometry):
    """The port's counterpart of tests/test_biem.py's test: the unscaled
    offset-table GMRES (float64 default: stable=False) against the direct
    solve; a lattice with repeated offsets under a Robin condition, and an
    irregular geometry (one pair per offset)."""
    c = create_from_branching_types("ba")
    if geometry == "lattice-2x2":
        kw = _robin_kw(_lattice(2), np.ones(4))
    else:
        rng = np.random.default_rng(3)
        kw = _robin_kw(rng.normal(size=(3, 3)) * np.array([6.0, 6.0, 3.0]), np.full(3, 0.7),
                       beta=0.0)
    cal_d = biem(c, **kw, solver="direct")
    cal_m = biem(c, **kw, solver="matfree")
    assert cal_m.matrix is None and cal_d.relres is None
    assert float(cal_m.relres) <= 1e-11
    dd, dm = cal_d.density, cal_m.density
    assert float((dm - dd).abs().max() / dd.abs().max()) < 1e-10


def test_bench_lattice_unscaled_matfree_matches_jax(jax_values):
    """The 4x4 lattice, solver="matfree", stable=False, at two k: the
    density of the JAX package's offset-table GMRES (committed:
    `jax_golden`)."""
    n_end = 4
    centers, direction = _bench_lattice_call()
    uin, _ = plane_wave(k=torch.tensor(KS), direction=torch.tensor(direction))
    calc = biem(create_from_branching_types("ba"), centers=torch.tensor(centers.copy()),
                radii=torch.ones(len(KS), 16, **F64), k=torch.tensor(KS), n_end=n_end,
                uin=uin, solver="matfree", stable=False)
    assert calc.matrix is None and float(calc.relres.max()) <= 1e-11
    d, d_ref = calc.density.numpy(), jax_values["bench lattice density"]
    assert np.abs(d - d_ref).max() <= 1e-9 * np.abs(d_ref).max()


def test_float64_bench_lattice_takes_the_offset_table_route(monkeypatch):
    """The bench lattice in float64 with the default solver and stable (the
    route chooser's "matfree", unscaled) builds the offset-table operator
    (n_end cut to 4 for the CPU; the route is held at n_end=32 by
    test_torch_dense.py's route table)."""
    built = []
    real = _core._offset_table_operator
    monkeypatch.setattr(_core, "_offset_table_operator",
                        lambda *a: built.append(a[-1]) or real(*a))
    monkeypatch.setattr(_core, "_route", lambda *a: "matfree")
    uin, _ = plane_wave(k=torch.tensor(1.3, **F64), direction=torch.tensor([1.0, 0.0, 0.0]))
    calc = biem(create_from_branching_types("ba"), centers=torch.tensor(_lattice()),
                radii=torch.ones(16, **F64), k=torch.tensor(1.3, **F64), n_end=4, uin=uin)
    assert built == [False] and calc.matrix is None and float(calc.relres) <= 1e-11


def _two_sphere_operator(rdt, stable, sr_map, n_end=24):
    """The README pair (unit spheres at t = 4, k = 1) at n_end: the
    matrix-free operator and the closed-form right-hand side."""
    c = create_from_branching_types("ba")
    centers = np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    f = dict(dtype=rdt)
    radii, k = torch.ones(1, 2, **f), torch.ones(1, **f)
    alpha, beta = torch.ones(1, 2, dtype=cdt), torch.zeros(1, 2, dtype=cdt)
    mv, diag = _core._matfree_operator(c, n_end, centers, radii, k, torch.ones(1, **f), alpha,
                                       beta, sr_map=sr_map, stable=stable)
    uin, _ = plane_wave(k=torch.tensor(1.0, **f), direction=torch.tensor([1.0, 0.0, 0.0], **f))
    rhs = _core._rhs_dispatch(c, n_end, torch.tensor(centers, **f), radii, alpha, beta, uin,
                              None, (1,)).reshape(1, -1)
    return mv, diag, rhs


def test_stable_offset_table_float32_past_the_overflow_wall():
    """n_end = 24 at t = 4, k = 1: the unscaled float32 table overflows
    (|h_42(4)| > 3.4e38); the scale-compensated offset table (reached
    through an sr_map) stays finite and within 1e-3 of the float64 solve."""
    mv, diag, rhs = _two_sphere_operator(torch.float32, True, lambda s: s)
    x32, relres, _ = gmres_solve_op(mv, diag, rhs)
    assert bool(torch.isfinite(x32).all()) and float(relres) <= 3e-5
    mv64, diag64, rhs64 = _two_sphere_operator(torch.float64, True, None)
    x64, _, _ = gmres_solve_op(mv64, diag64, rhs64)
    assert float((x32.to(torch.complex128) - x64).abs().max()) <= 1e-3 * float(x64.abs().max())
    mv_u, diag_u, _ = _two_sphere_operator(torch.float32, False, None)
    y = mv_u(torch.ones_like(rhs))
    assert not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(diag_u).all()))
