"""The lattice-FFT route and the route chooser's lattice test, against the
JAX package and the port's own direct solve, on the CPU in float64.

Tolerances: the lattice operator is the dense operator's sum by another
road (FFTs of the block convolution), so one matvec agrees with the
dense pair-major matvec to 1e-12 of its largest entry; solves stop at the
float64 GMRES tolerance 1e-11 (relative preconditioned residual), so
densities agree with a direct solve, and with the JAX package's, to 1e-9
of the largest entry; the n_balls anchor is the JAX package's test value
to its 1e-8.  The JAX solves of the 3 x 3 case are committed in
tests/golden/test_torch_lattice.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
from biem_helmholtz_sphere_tpu.biem._lattice import lattice_routing as j_lattice_routing
from biem_helmholtz_sphere_tpu.cli._accuracy import lattice_centers
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

F64 = dict(dtype=torch.float64)


def _broken():
    c = lattice_centers(3, 2)
    c[4, 0] += 0.37
    return c


_GEOMETRIES = {
    "square-4x4": lattice_centers(4, 2),
    "plane-z0-3x3": np.concatenate([lattice_centers(3, 2), np.zeros((9, 1))], axis=1),
    "line-5": np.stack([3.0 * np.arange(5), np.zeros(5), np.zeros(5)], axis=1),
    "rectangle-3x5": np.stack(np.meshgrid(np.arange(3) * 4.0, np.arange(5) * 5.5),
                              axis=-1).reshape(-1, 2)[::-1].copy(),
    "pair": np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]),
    "irregular": np.random.default_rng(3).normal(size=(5, 3)) * 6.0,
    "one-moved": _broken(),
}


@pytest.mark.parametrize("name", list(_GEOMETRIES))
def test_lattice_routing_matches_jax(name):
    """The port's lattice detector returns what the JAX package's does:
    None off a lattice, else the same axes, spacings, shape and cell maps."""
    centers = _GEOMETRIES[name]
    got, ref = _lattice.lattice_routing(centers), j_lattice_routing(centers)
    assert (got is None) == (ref is None)
    assert (got is None) == (name in ("pair", "irregular", "one-moved"))
    if got is None:
        return
    assert got[0] == ref[0] and got[2] == ref[2]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])
    assert (got[3][got[4]] == np.arange(len(centers))).all()


def _args(c, n_end, centers, ks, alpha=1.0, beta=0.5, eta=1.0):
    """biem()'s flattened arguments (c, n_end, radii, k, eta, alpha, beta)
    for unit spheres at k [K] (real or complex)."""
    n_k, nb = len(ks), len(centers)
    k = torch.tensor(ks)
    cdt = torch.complex128
    return (c, n_end, torch.ones(n_k, nb, **F64), k, torch.full((n_k,), eta, **F64),
            torch.full((n_k, nb), alpha, dtype=cdt), torch.full((n_k, nb), beta, dtype=cdt))


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("btype,n_side,n_end", [("a", 3, 6), ("a", 4, 9), ("ba", 3, 4)])
def test_lattice_matvec_equals_the_dense_matvec(btype, n_side, n_end, stable):
    """One lattice matvec (FFT block convolution) against the dense
    pair-major matvec of the same system (KD on `_assembly_parts`), two k
    (one complex), Robin data, stable and plain."""
    c = create_from_branching_types(btype)
    centers = lattice_centers(n_side, c.c_ndim)
    args = _args(c, n_end, centers, np.array([1.1 + 0.2j, 0.7]))
    mv, diag = _lattice.lattice_operator(c, n_end, centers, *args[2:], stable=stable)
    a5 = _core._assemble(c, n_end, centers, *args[2:], stable=stable, pair_major=True)
    mv_d, diag_d = _core._pairs_operator(a5)
    x = torch.tensor(np.random.default_rng(1).normal(size=diag.shape)
                     + 1j * np.random.default_rng(2).normal(size=diag.shape))
    ref = mv_d(x)
    assert float((mv(x) - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert float((diag - diag_d).abs().max()) <= 1e-14 * float(diag_d.abs().max())


def _j_solve(btype, centers, ks, n_end, **kw):
    d = centers.shape[1]
    direction = np.broadcast_to(np.eye(d)[0][:, None], (d, len(ks))).copy()
    uin, uin_grad = j_plane_wave(k=ks, direction=direction)
    return j_biem(j_tree(btype), centers=np.broadcast_to(centers, (len(ks),) + centers.shape),
                  radii=np.ones((len(ks), len(centers))), k=ks, n_end=n_end, uin=uin,
                  uin_grad=uin_grad, **kw)


def _t_solve(btype, centers, ks, n_end, **kw):
    d = centers.shape[1]
    direction = np.broadcast_to(np.eye(d)[0][:, None], (d, len(ks))).copy()
    uin, uin_grad = plane_wave(k=torch.tensor(ks), direction=torch.tensor(direction))
    return biem(create_from_branching_types(btype),
                centers=torch.tensor(np.broadcast_to(centers, (len(ks),) + centers.shape).copy()),
                radii=torch.ones(len(ks), len(centers), **F64), k=torch.tensor(ks),
                n_end=n_end, uin=uin, uin_grad=uin_grad, **kw)


KB_3X3 = (0.9, 1.3)


def jax_golden():
    """The JAX package's solves that test_3x3_lattice_case_of_the_jax_package
    reads: the 3 x 3 'a' case by its direct and matrix-free routes, and
    each k of KB_3X3 by its direct route."""
    centers = lattice_centers(3, 2)
    kw = dict(alpha=1.0, beta=0.5, eta=np.ones(1))
    out = {f"3x3 {solver}": _j_solve("a", centers, np.array([1.1]), 6, solver=solver,
                                     **kw).density.to_numpy()
           for solver in ("direct", "matfree")}
    for ki in KB_3X3:
        out[f"3x3 direct k={ki}"] = _j_solve("a", centers, np.array([ki]), 5, solver="direct",
                                             beta=0.0).density.to_numpy()
    return out


def test_3x3_lattice_case_of_the_jax_package():
    """The JAX package's 3 x 3 'a' case (tests/test_biem.py), k = 1.1,
    Robin (alpha 1, beta 0.5), n_end = 6: the lattice operator under GMRES
    against the port's direct solve and the JAX package's direct and
    matrix-free ones; then two k in one call through the lattice operator
    against each k's JAX direct solve (the JAX solves committed:
    `jax_golden`; its matrix-free compile takes minutes on the CPU)."""
    c = create_from_branching_types("a")
    centers = lattice_centers(3, 2)
    ks = np.array([1.1])
    kw = dict(alpha=1.0, beta=0.5, eta=np.ones(1))
    jax_values = _jax_golden.load("test_torch_lattice")
    direct = _t_solve("a", centers, ks, 6, solver="direct", **kw).density.reshape(1, -1)
    d_ref, m_ref = jax_values["3x3 direct"], jax_values["3x3 matfree"]
    calc = _t_solve("a", centers, ks, 6, solver="matfree", **kw)
    f_exp = _core._rhs_dispatch(c, 6, torch.tensor(centers), torch.ones(1, 9, **F64),
                                torch.ones(1, 9, dtype=torch.complex128),
                                torch.full((1, 9), 0.5, dtype=torch.complex128),
                                *plane_wave(k=torch.tensor(1.1, **F64),
                                            direction=torch.tensor([1.0, 0.0])), (1,))
    mv, diag = _lattice.lattice_operator(c, 6, centers, *_args(c, 6, centers, ks)[2:])
    x, relres, _ = gmres_solve_op(mv, diag, f_exp.reshape(1, -1))
    assert float(relres.max()) <= 1e-11
    scale = float(direct.abs().max())
    for got in (x, calc.density.reshape(1, -1)):
        assert float((got - direct).abs().max()) <= 1e-9 * scale
    for ref in (d_ref, m_ref):
        assert np.abs(x.numpy().reshape(ref.shape) - ref).max() <= 1e-9 * scale
    # two k in one call, each against its own JAX direct solve
    kb = np.array(KB_3X3)
    args = _args(c, 5, centers, kb, beta=0.0)
    mv, diag = _lattice.lattice_operator(c, 5, centers, *args[2:])
    uin, _ = plane_wave(k=torch.tensor(kb), direction=torch.tensor([[1.0, 1.0], [0.0, 0.0]]))
    f_exp = _core._rhs_dispatch(c, 5, torch.tensor(centers), args[2], args[5], args[6], uin,
                                None, (2,))
    x, _, _ = gmres_solve_op(mv, diag, f_exp.reshape(2, -1))
    for i, ki in enumerate(KB_3X3):
        ref = jax_values[f"3x3 direct k={ki}"].reshape(-1)
        assert np.abs(x[i].numpy() - ref).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize("stable", [True, False])
def test_8x8_ba_lattice_route_matches_direct(stable):
    """An 8 x 8 'ba' lattice (64 spheres) at n_end = 4: solver="auto" takes
    the lattice route (K2 + the rotation sandwich for the half table) and
    agrees with the direct LU."""
    centers = lattice_centers(8, 3)
    ks = np.array([1.0, 1.4])
    calc = _t_solve("ba", centers, ks, 4, stable=stable)
    assert calc.matrix is None and calc.iters is not None
    direct = _t_solve("ba", centers, ks, 4, stable=stable, solver="direct")
    scale = float(direct.density.abs().max())
    assert float((calc.density - direct.density).abs().max()) <= 1e-9 * scale
