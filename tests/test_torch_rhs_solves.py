"""Solves with the quadrature right-hand side: a point source against the JAX
package, the closed form and a grid of k against single solves, on the CPU
(split from test_torch_rhs.py so the test workers share them; tolerances as
there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu import biem as j_biem
from biem_helmholtz_sphere_tpu import point_source as j_point_source
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import biem, plane_wave, point_source
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import sphere_quadrature

from test_torch_rhs import (  # noqa: F401 (fixtures)
    CENTERS,
    DIRECTION,
    F64,
    N_END,
    RADII,
    SOURCE,
)


@pytest.mark.parametrize("ab", [(1.0, 0.0), (0.0, 1.0), (1.0, 0.5)])
def test_quadrature_solve_matches_closed_form(ab):
    """Tag-stripped plane-wave closures take the quadrature; both solves
    agree to quadrature-truncation accuracy (tests/test_biem.py's bound)."""
    alpha, beta = ab
    k = torch.tensor(1.3, **F64)
    uin, uin_grad = plane_wave(k=k, direction=torch.tensor(DIRECTION))

    def solve(u, ug):
        return biem(create_from_branching_types("ba"), centers=torch.tensor(CENTERS),
                    radii=torch.tensor(RADII), k=k, n_end=N_END, alpha=alpha, beta=beta,
                    uin=u if alpha else None, uin_grad=ug if beta else None)

    ref = solve(lambda x, /: uin(x), lambda x, /: uin_grad(x)).density.numpy()
    got = solve(uin, uin_grad).density.numpy()
    np.testing.assert_allclose(got, ref, atol=np.abs(ref).max() * 1e-6)


@pytest.mark.parametrize("solver", ["auto", "matfree"])
def test_point_source_solve_matches_jax(solver):
    """A point source through biem() (quadrature right-hand side), on the
    direct LU and on the unscaled offset-table GMRES, against the JAX
    package's density and near field."""
    uj, _ = j_point_source(k=np.asarray(1.3), source=SOURCE)
    ref = j_biem(j_tree("ba"), centers=CENTERS, radii=RADII, k=np.asarray(1.3), n_end=N_END,
                 uin=uj, solver=solver)
    u, _ = point_source(k=torch.tensor(1.3, **F64), source=torch.tensor(SOURCE))
    calc = biem(create_from_branching_types("ba"), centers=torch.tensor(CENTERS),
                radii=torch.tensor(RADII), k=torch.tensor(1.3, **F64), n_end=N_END, uin=u,
                solver=solver)
    d, d_ref = calc.density.numpy(), tonp(ref.density)
    assert np.abs(d - d_ref).max() <= 1e-10 * np.abs(d_ref).max()
    x = np.array([[3.0, 0.0], [0.0, 0.1], [0.0, 1.5]])
    np.testing.assert_allclose(calc.uscat(torch.tensor(x)).numpy(), tonp(ref.uscat(x)),
                               rtol=1e-9)


@pytest.mark.parametrize("field", ["plane-wave", "point-source"])
def test_k_grid_matches_six_single_solves(field):
    """k of shape [2, 3] (eta and radii broadcast from it): density,
    relres, uscat and uin keep the grid's axes, and each entry equals the
    solve at that one k; the closures receive x [d, Q, B, 2, 3]."""
    ks = np.array([[1.0, 1.2, 1.4], [1.6, 1.8, 2.0]])
    c = create_from_branching_types("ba")
    cen = torch.tensor(np.broadcast_to(CENTERS, (2, 3, 2, 3)).copy())
    seen = []

    def fields(k):
        kt = torch.tensor(k, **F64)
        if field == "plane-wave":
            d = torch.tensor(DIRECTION)[(slice(None),) + (None,) * kt.ndim].expand(
                (3,) + kt.shape)
            u, _ = plane_wave(k=kt, direction=d)
            return u
        s = torch.tensor(SOURCE)[(slice(None),) + (None,) * kt.ndim].expand((3,) + kt.shape)
        u, _ = point_source(k=kt, source=s)
        return lambda x: seen.append(tuple(x.shape)) or u(x)

    kw = dict(n_end=6, solver="matfree")
    grid = biem(c, centers=cen, radii=torch.tensor(np.broadcast_to(RADII, (2, 3, 2)).copy()),
                k=torch.tensor(ks), uin=fields(ks), **kw)
    assert grid.density.shape == (2, 3, 2, 36) and grid.relres.shape == (2, 3)
    x = torch.tensor([[3.0, 0.0], [0.0, 0.1], [0.0, 1.5]])
    u_grid = grid.uscat(x)
    assert u_grid.shape == (2, 2, 3) and grid.uin(x).shape == (2, 2, 3)
    if field == "point-source":
        n_q = len(sphere_quadrature(c, 2 * (kw["n_end"] - 1) + 1)[1])
        assert seen[0] == (3, n_q, 2, 2, 3)
    for i in range(2):
        for j in range(3):
            one = biem(c, centers=torch.tensor(CENTERS), radii=torch.tensor(RADII),
                       k=torch.tensor(ks[i, j], **F64), uin=fields(ks[i, j]), **kw)
            d1 = one.density
            assert float((grid.density[i, j] - d1).abs().max()) <= 1e-10 * float(
                d1.abs().max())
            u1 = one.uscat(x)
            assert float((u_grid[:, i, j] - u1).abs().max()) <= 1e-9 * float(u1.abs().max())
