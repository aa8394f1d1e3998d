"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; without them they skip.  They
import no JAX, so they also run where the JAX package is not installed,
without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerances: complex64 1e-4 and complex128 1e-10 of the largest plain
value (the kernels sum in another order; float32 keeps ~7 digits).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch.biem._core import _child_state_blocks, _pair_routing
from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
    _fused_ba_eval_plain,
    fused_ba_eval,
    regroup,
)
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
    _block_diag_cmm_plain,
    block_diag_cmm,
    pack,
    unpack,
)
from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
    _lane_gather_plain,
    _lane_scatter_plain,
    lane_gather,
    lane_scatter,
    make_route,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _lattice(n_side=4, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _randc(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    tol = 1e-4 if dtype == torch.complex64 else 1e-10
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(27)
    c = create_from_branching_types("ba")
    n_end, n_k = 8, 2
    centers = _lattice()
    nb, h = len(centers), n_end * n_end
    ell = basis(c, n_end).n_root
    rt = _pair_routing(centers)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for sizes, perm, stack in ((2 * np.arange(n_end) + 1, None, (len(rt.uniq),)),
                               (*_child_state_blocks(c, n_end), (n_k, len(rt.uniq_r)))):
        bd = pack(t(np.zeros(stack + (h, h))), sizes, perm)
        bd = replace(bd, vals=t(_randc(rng, bd.vals.shape)))
        x = t(_randc(rng, (n_k,) + stack[-1:] + (8, h)))
        for adj in (False, True):
            assert rel(block_diag_cmm(bd, x, adj),
                       _block_diag_cmm_plain(unpack(bd), x, adj)) < tol

    route = make_route(rt.src, rt.dst, rt.p_max, nb, cuda)
    pm = t((-1.0) ** (ell % 2), rdt)
    x, blc, diag, reg = (t(_randc(rng, (n_k, nb, h))) for _ in range(4))
    y = t(_randc(rng, (n_k, len(rt.src), h)))
    assert rel(lane_gather(x, blc, pm, route), _lane_gather_plain(x, blc, pm, route)) < tol
    assert rel(lane_scatter(y, x, diag, reg, pm, route),
               _lane_scatter_plain(y, x, diag, reg, pm, route)) < tol

    w2 = regroup(c, n_end, t(_randc(rng, (n_k, nb, h)) * np.exp(-0.7 * ell)))
    pts = rng.normal(size=(3, 1200)) * 10.0
    r = np.linalg.norm(pts[:, :, None] - centers.T[:, None, :], axis=0)
    pts = t(pts[:, (r > 1.05).all(axis=1)], rdt)[:, None, :]
    cen, ks = t(centers, rdt), t([1.5, 2.5], rdt)
    for far in (False, True):
        for per_ball in (False, True):
            assert rel(fused_ba_eval(pts, cen, ks, w2, far=far, per_ball=per_ball),
                       _fused_ba_eval_plain(pts, cen, ks, w2, far, per_ball)) < tol


@pytest.mark.requires_cuda
def test_cuda_launch_failure_raises(cuda):
    """A launch the card refuses (a block larger than shared memory) raises,
    and the next launch is not poisoned by the stale error."""
    bd = pack(torch.zeros((1, 400, 400), dtype=torch.complex128, device=cuda),
              np.array([400]))
    x = torch.zeros((1, 1, 400), dtype=torch.complex128, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        block_diag_cmm(bd, x)
    ok = pack(torch.eye(4, dtype=torch.complex128, device=cuda)[None], np.array([1, 3]))
    v = torch.ones((1, 2, 4), dtype=torch.complex128, device=cuda)
    assert torch.equal(block_diag_cmm(ok, v), v)
