"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; without them they skip.  They
import no JAX, so they also run where the JAX package is not installed,
without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerances: complex64 1e-4 and complex128 1e-10 of the largest plain
value (the kernels sum in another order; float32 keeps ~7 digits).  The
special functions (K5) are compared entry by entry on values,
mant_k exp(e_k - e_p) against mant_p, to the same relative tolerances.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch import special
from biem_helmholtz_sphere_tpu_torch.biem._core import (
    _assembly_parts,
    _factored_operator,
    _matfree_operator,
    _pair_routing,
    _radial_rows_scaled,
)
from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
    _fused_ba_eval_plain,
    fused_ba_eval,
    regroup,
)
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.ops import kernels
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
    LaneSegments,
    _block_diag_cmm_plain,
    block_diag_cmm,
    pack,
    unpack,
)
from biem_helmholtz_sphere_tpu_torch.ops.dense import _dense_assemble_plain, dense_assemble
from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
    _lane_gather_plain,
    _lane_scatter_plain,
    lane_gather,
    lane_scatter,
    make_route,
)
from biem_helmholtz_sphere_tpu_torch.special._family import (
    _H_ONLY,
    _SCALED,
    _UNSCALED,
    _spherical_h_scaled_plain,
    _spherical_jh_all_plain,
    _spherical_jh_scaled_plain,
    spherical_jh,
)
from biem_helmholtz_sphere_tpu_torch.ops.coax_u import _coax_u_plain, coax_u
from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
    _coax_tables_on,
    _coaxial_sr_plain,
    coaxial_sr,
)
from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
    _child_state_blocks,
    _coax_fold_packed_plain,
    _coax_packed,
    _coax_plan_on,
    coax_fold,
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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _same_bits(a, b):
    """Bitwise equal tensors, or nested tuples of them (NaN included)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))

    def bits(t):
        return (torch.view_as_real(t) if t.is_complex() else t).contiguous().view(torch.uint8)
    return torch.equal(bits(a), bits(b))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    """KB and KC on the lattice routing's compacted lanes, and KA, at
    n_end = 8 (KA's generic instance)."""
    tol = _tol(dtype)
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

    x = t(_randc(rng, (n_k, len(rt.src), h)))
    for sizes, perm, stack, ptr in (
        (2 * np.arange(n_end) + 1, None, (len(rt.uniq),), rt.slot_ptr),
        (*_child_state_blocks(c, n_end), (n_k, len(rt.uniq_r)), rt.rad_ptr),
    ):
        bd = pack(t(np.zeros(stack + (h, h))), sizes, perm)
        bd = replace(bd, vals=t(_randc(rng, bd.vals.shape)))
        seg = LaneSegments(tuple(int(v) for v in ptr))
        for adj in (False, True):
            assert _rel(block_diag_cmm(bd, x, seg, adj),
                        _block_diag_cmm_plain(unpack(bd), x, seg, adj)) < tol

    route = make_route(rt.src, rt.dst, rt.dn, nb, cuda)
    pm = t((-1.0) ** (ell % 2), rdt)
    xb, blc, diag, reg = (t(_randc(rng, (n_k, nb, h))) for _ in range(4))
    assert _rel(lane_gather(xb, blc, pm, route), _lane_gather_plain(xb, blc, pm, route)) < tol
    assert _rel(lane_scatter(x, xb, diag, reg, pm, route),
                _lane_scatter_plain(x, xb, diag, reg, pm, route)) < tol

    w2 = regroup(c, n_end, t(_randc(rng, (n_k, nb, h)) * np.exp(-0.7 * ell)))
    pts = rng.normal(size=(3, 1200)) * 10.0
    r = np.linalg.norm(pts[:, :, None] - centers.T[:, None, :], axis=0)
    pts = t(pts[:, (r > 1.05).all(axis=1)], rdt)[:, None, :]
    cen, ks = t(centers, rdt), t([1.5, 2.5], rdt)
    for far in (False, True):
        for per_ball in (False, True):
            assert _rel(fused_ba_eval(pts, cen, ks, w2, far=far, per_ball=per_ball),
                        _fused_ba_eval_plain(pts, cen, ks, w2, far, per_ball)) < tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_block_diag_cmm_unit_blocks_and_empty_segments(cuda, dtype):
    """KB with g = 1 blocks (a diagonal matrix), a matrix with no lanes,
    a shared and a per-k stack, and X's permutation; two launches are
    bitwise equal and no lane is left unwritten."""
    rng = np.random.default_rng(41)
    h, n_k = 9, 3
    seg = LaneSegments((0, 0, 5, 5, 7))  # matrices 0 and 2 have no lanes
    x = torch.as_tensor(_randc(rng, (n_k, 7, h)), dtype=dtype, device=cuda)
    for sizes, perm, stack in ((np.ones(h, int), None, (4,)),
                               (np.array([1, 3, 1, 4]), rng.permutation(h), (n_k, 4)),
                               (np.array([1, 3, 5]), None, (4,))):
        bd = pack(torch.zeros(stack + (h, h), dtype=dtype, device=cuda), sizes, perm)
        bd = replace(bd, vals=torch.as_tensor(_randc(rng, bd.vals.shape), dtype=dtype,
                                              device=cuda))
        for adj in (False, True):
            got = block_diag_cmm(bd, x, seg, adj)
            assert _rel(got, _block_diag_cmm_plain(unpack(bd), x, seg, adj)) < _tol(dtype)
            assert _same_bits(block_diag_cmm(bd, x, seg, adj), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_pts", [1, 131072])
def test_fused_ba_eval_both_modes(cuda, dtype, n_pts):
    """KA at the bench widths (n_end = 32, 16 balls) in its few-point mode
    (1 point x 4 k, uscat(0)) and its many-point mode (131,072 points x
    1 k): near, far and per ball against the plain version; the mode the
    shape selects is the one launched; two launches are bitwise equal."""
    from biem_helmholtz_sphere_tpu_torch.ops.kernels import FEW_POINTS

    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(43)
    c = create_from_branching_types("ba")
    n_end, centers = 32, _lattice()
    n_k = 4 if n_pts == 1 else 1
    ell = basis(c, n_end).n_root
    w2 = regroup(c, n_end, torch.as_tensor(
        _randc(rng, (n_k, len(centers), n_end * n_end)) * np.exp(-ell), dtype=dtype,
        device=cuda))
    cen = torch.as_tensor(centers, dtype=rdt, device=cuda)
    ks = torch.as_tensor(np.linspace(7.0, 8.0, n_k), dtype=rdt, device=cuda)
    raw = rng.normal(size=(3, n_pts))
    # uscat(0) for one point: the origin lies outside every sphere of the lattice
    near = torch.as_tensor(raw * (0.0 if n_pts == 1 else 20.0), dtype=rdt,
                           device=cuda)[:, None, :]
    far_x = torch.as_tensor(raw / np.linalg.norm(raw, axis=0), dtype=rdt,
                            device=cuda)[:, None, :]
    keep = (torch.linalg.vector_norm(near[:, 0, :, None] - cen.T[:, None, :], dim=0)
            > 1.0).all(-1)
    few = n_pts * n_k < FEW_POINTS
    for far, xx in ((False, near), (True, far_x)):
        for per_ball in (False, True):
            counts = (fused_ba_eval.launches, fused_ba_eval.few_launches)
            got = fused_ba_eval(xx, cen, ks, w2, far=far, per_ball=per_ball)
            assert (fused_ba_eval.launches - counts[0],
                    fused_ba_eval.few_launches - counts[1]) == ((0, 1) if few else (1, 0))
            ref = _fused_ba_eval_plain(xx, cen, ks, w2, far, per_ball)
            m = slice(None) if far else keep
            assert _rel(got[m], ref[m]) < _tol(dtype), (far, per_ball)
            assert _same_bits(fused_ba_eval(xx, cen, ks, w2, far=far, per_ball=per_ball), got)


@pytest.mark.requires_cuda
def test_cuda_launch_failure_raises(cuda):
    """A launch the card refuses (more shared memory than a block may have:
    KA's generic instance at n_end = 200 in complex128) raises, and the
    next launch is not poisoned by the stale error."""
    def call(n_end):
        w2 = torch.zeros((1, 1, 2 * n_end - 1, n_end), dtype=torch.complex128, device=cuda)
        x = torch.ones((3, 1, 600), dtype=torch.float64, device=cuda)
        cen = torch.zeros((1, 3), dtype=torch.float64, device=cuda)
        return fused_ba_eval(x, cen, torch.ones(1, dtype=torch.float64, device=cuda), w2)

    with pytest.raises(RuntimeError, match="CUDA error"):
        call(200)
    assert torch.equal(call(4), torch.zeros((600, 1), dtype=torch.complex128, device=cuda))


def _tol(dtype):
    return 1e-4 if dtype == torch.complex64 else 1e-10


def _scaled_rel(got, ref, keep=None):
    """Largest entrywise relative error of scaled values (mant, e)."""
    (mk, ek), (mp, ep) = got, ref
    assert bool(torch.isfinite(mk).all()) and bool(torch.isfinite(ek).all())
    rel = (mk * torch.exp(ek - ep) - mp).abs() / mp.abs().clamp_min(torch.finfo(ek.dtype).tiny)
    return float(rel.max() if keep is None else rel[keep].max())


def _unscaled_rel(got, ref, keep):
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    tiny = torch.finfo(ref.real.dtype).tiny
    return float(((got - ref).abs() / ref.abs().clamp_min(tiny))[fin & keep].max())


def _keep(d, name, z, n_end):
    """The entries compared: all but j_0' of d >= 5 at |z| < 2.  There
    j_0' = -z/15 + ... is the difference of O(1) terms, so each version
    loses ~15/|z|^2 ulps of it (all of float32's digits at |z| = 1e-3) and
    two roundings of it cannot agree to the tolerance; every other order
    is held over the whole |z| range."""
    keep = torch.ones(z.shape + (n_end,), dtype=torch.bool, device=z.device)
    if d > 3 and name == "jp":
        keep[..., 0] = z.abs() >= 2.0
    return keep


# |z| from 1e-3 to 60 across the n <= |z| switch, complex z, and z = 0.5
# where h_n in float32 passes the overflow wall (|h_40(0.5)| ~ 1e74)
_Z = np.concatenate([np.geomspace(1e-3, 60.0, 29), [8.0, 3.0 + 2.0j, 15.0 - 0.5j, 0.5]])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("d", [3, 5])
def test_spherical_jh_kernel_matches_plain(cuda, dtype, d):
    """K5 in its three modes against the plain versions on the card, at
    n_end from 1 to 64 (a lane per order, past 32 orders; the m > 0
    window), h alone over 2 n_end - 1 bands (up to 127) and at z = 0 in
    the unscaled mode; two launches are bit for bit equal."""
    z = torch.as_tensor(_Z, dtype=dtype, device=cuda).reshape(-1, 1)
    tol = _tol(dtype)
    names = ("j", "jp", "h", "hp")
    zu = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), z.reshape(-1)])
    # past n_end = 16 the unscaled float32 values stay finite at every
    # order only where |z| >= 20
    zu_far = torch.cat([zu[:1], zu[zu.abs() >= 20.0]])
    n0 = spherical_jh.launches
    n_ends = (1, 2, 16, 24, 31, 32, 33, 41, 63, 64)
    for n_end in n_ends:
        got = spherical_jh(_SCALED, d, n_end, z)
        ref = _spherical_jh_scaled_plain(d, n_end, z)
        for name, g, r in zip(names, got, ref):
            assert g[0].shape == r[0].shape == z.shape + (n_end,)
            assert _scaled_rel(g, r, _keep(d, name, z, n_end)) < tol, (n_end, name)
        assert _same_bits(spherical_jh(_SCALED, d, n_end, z), got)
        # h alone over the coax's 2 n_end - 1 bands.  Past |e| = 1024 one
        # float32 ulp of an exponent (1.2e-4) exceeds the tolerance, and
        # e + ln rounds independently in the two versions; past 81 bands
        # |e| reaches 1024 only at |z| < 0.03, so complex64 holds the values
        # there to being finite and compares them from |z| = 0.03 on
        n_h = 2 * n_end - 1
        keep_h = torch.ones(z.shape + (n_h,), dtype=torch.bool, device=cuda)
        if dtype == torch.complex64 and n_h > 81:
            keep_h &= (z.abs() >= 0.03)[..., None]
        got = spherical_jh(_H_ONLY, d, n_h, z)
        assert _scaled_rel(got, _spherical_h_scaled_plain(d, n_h, z), keep_h) < tol, n_end
        assert _same_bits(spherical_jh(_H_ONLY, d, n_h, z), got)
        zz = zu if n_end <= 16 else zu_far
        got = spherical_jh(_UNSCALED, d, n_end, zz)
        for name, g, r in zip(names, got, _spherical_jh_all_plain(d, n_end, zz)):
            keep = _keep(d, name, zz, n_end)
            keep[0] = True  # the z = 0 limits are exact
            assert _unscaled_rel(g, r, keep) < tol, (n_end, name)
        assert _same_bits(spherical_jh(_UNSCALED, d, n_end, zz), got)
    assert spherical_jh.launches == n0 + 6 * len(n_ends)


@pytest.mark.requires_cuda
def test_small_argument_seeds_use_the_series_on_the_card(cuda):
    """The kernel's seeds follow the port at |z| < 1e-4 (the series for j,
    the closed form for h), as test_small_argument_seeds_use_the_series
    holds the plain version."""
    z = np.array([5e-5, 2e-4])
    zt = torch.tensor(z, dtype=torch.float64, device=cuda)
    j, _, h, _ = special.spherical_jh_all(3, 3, zt)
    j, h = j.cpu().numpy(), h.cpu().numpy()
    np.testing.assert_allclose(j[:, 0].real, np.sin(z) / z, rtol=1e-15)
    np.testing.assert_allclose(j[:, 1].real, z / 3 * (1 - z * z / 10), rtol=1e-12)
    np.testing.assert_allclose(j[:, 2].real, z * z / 15, rtol=1e-8)
    np.testing.assert_allclose(h[:, 0], -1j * np.exp(1j * z) / z, rtol=1e-15)
    hm, he = special.spherical_h_scaled(3, 3, zt)
    h_s = (hm * torch.exp(he)).cpu().numpy()
    np.testing.assert_allclose(h_s[:, 1], -np.exp(1j * z) * (z + 1j) / z**2, rtol=1e-14)


@pytest.mark.requires_cuda
def test_spherical_jh_even_dimension_raises_before_launch(cuda):
    """Even d launches K5's base-2 mode now (the test below holds it to
    the plain version); a dimension below 2 raises before any launch."""
    n0 = spherical_jh.launches
    with pytest.raises(ValueError, match="dimension must be >= 2"):
        special.spherical_jh_scaled(1, 5, torch.ones(3, dtype=torch.complex64, device=cuda))
    assert spherical_jh.launches == n0
    special.spherical_jh_scaled(4, 5, torch.ones(3, dtype=torch.complex64, device=cuda))
    assert spherical_jh.launches == n0 + 1


# |z| on both sides of the cylinder seeds' seam at 14, Im z up to 1, small
# |z| and z = 0.5 (h_n past the float32 overflow wall at the higher orders)
_Z2 = np.concatenate([np.geomspace(1e-2, 60.0, 21), [13.5, 13.99, 14.01, 14.5],
                      [13.9 + 1.0j, 14.1 + 0.5j, 5.0 + 1.0j, 30.0 + 0.3j, 0.5]])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("d", [2, 4, 6])
def test_spherical_jh_base2_kernel_matches_plain(cuda, dtype, d):
    """K5's base-2 (even d) mode against the plain versions on the card:
    scaled, h alone and unscaled, n_end 1 to 64, both sides of the seam;
    two launches are bit for bit equal.  Tolerances as the odd-d test's
    (both versions take the cylinder seeds in float64)."""
    z = torch.as_tensor(_Z2, dtype=dtype, device=cuda).reshape(-1, 1)
    tol = _tol(dtype)
    names = ("j", "jp", "h", "hp")
    zu = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), z.reshape(-1)])
    zu_far = torch.cat([zu[:1], zu[zu.abs() >= 20.0]])
    for n_end in (1, 2, 16, 31, 32, 33, 64):
        got = spherical_jh(_SCALED, d, n_end, z)
        ref = _spherical_jh_scaled_plain(d, n_end, z)
        for name, g, r in zip(names, got, ref):
            assert _scaled_rel(g, r, _keep(d, name, z, n_end)) < tol, (n_end, name)
        assert _same_bits(spherical_jh(_SCALED, d, n_end, z), got)
        n_h = 2 * n_end - 1
        keep_h = torch.ones(z.shape + (n_h,), dtype=torch.bool, device=cuda)
        if dtype == torch.complex64 and n_h > 81:
            keep_h &= (z.abs() >= 0.03)[..., None]
        got = spherical_jh(_H_ONLY, d, n_h, z)
        assert _scaled_rel(got, _spherical_h_scaled_plain(d, n_h, z), keep_h) < tol, n_end
        zz = zu if n_end <= 16 else zu_far
        got = spherical_jh(_UNSCALED, d, n_end, zz)
        for name, g, r in zip(names, got, _spherical_jh_all_plain(d, n_end, zz)):
            keep = _keep(d, name, zz, n_end)
            keep[0] = True
            assert _unscaled_rel(g, r, keep) < tol, (n_end, name)
        assert _same_bits(spherical_jh(_UNSCALED, d, n_end, zz), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_pts", [1, 131072])
def test_fused_ba_eval_complex_k_and_per_k_centers(cuda, dtype, n_pts):
    """KA with a complex k and each k's own centers (the lattice at four
    pitches) in both modes, near, far and per ball, against the plain
    version; two launches are bitwise equal."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(47)
    c = create_from_branching_types("ba")
    n_end, n_k = 32, 4
    ell = basis(c, n_end).n_root
    geo = np.stack([_lattice(spacing=s) for s in (4.0, 4.5, 5.0, 5.5)])
    cen = torch.as_tensor(geo, dtype=rdt, device=cuda)
    ks = torch.as_tensor(np.linspace(7.0, 8.0, n_k) + 0.1j, dtype=dtype, device=cuda)
    w2 = regroup(c, n_end, torch.as_tensor(
        _randc(rng, (n_k, 16, n_end * n_end)) * np.exp(-ell), dtype=dtype, device=cuda))
    raw = rng.normal(size=(3, n_pts))
    near = torch.as_tensor(raw * (0.0 if n_pts == 1 else 25.0), dtype=rdt,
                           device=cuda)[:, None, :]
    far_x = torch.as_tensor(raw / np.linalg.norm(raw, axis=0), dtype=rdt,
                            device=cuda)[:, None, :]
    keep = (torch.linalg.vector_norm(near[:, 0, :, None, None] - cen.permute(2, 0, 1)[:, None],
                                     dim=0) > 1.0).all(-1)  # [P, K]
    for far, xx in ((False, near), (True, far_x)):
        for per_ball in (False, True):
            got = fused_ba_eval(xx, cen, ks, w2, far=far, per_ball=per_ball)
            ref = _fused_ba_eval_plain(xx, cen, ks, w2, far, per_ball)
            m = slice(None) if far else keep
            assert _rel(got[m], ref[m]) < _tol(dtype), (far, per_ball)
            assert _same_bits(fused_ba_eval(xx, cen, ks, w2, far=far, per_ball=per_ball), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pair_major", [True, False])
def test_dense_assemble_per_k_pid(cuda, dtype, pair_major):
    """KD with each k's own pair map (two geometries along the batch, the
    dense route's own arguments, complex k) equals its plain version entry
    for entry; two launches are bit for bit equal."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=cuda)
    geo = np.stack([_lattice(), _lattice(spacing=4.5)[::-1]])
    ks = torch.tensor([1.3 + 0.1j, 2.1 + 0.05j], dtype=dtype, device=cuda)
    for stable in (True, False):
        parts = _assembly_parts(
            create_from_branching_types("ba"), 8, geo, torch.ones(2, 16, **f), ks,
            torch.ones(2, **f), torch.ones(2, 16, dtype=dtype, device=cuda),
            torch.zeros(2, 16, dtype=dtype, device=cuda), stable=stable)
        assert parts[1].shape == (2, 16, 16)
        got = dense_assemble(*parts, pair_major=pair_major)
        ref = _dense_assemble_plain(*parts, pair_major)
        assert bool(torch.isfinite(ref).all()) and torch.equal(got, ref), _rel(got, ref)
        assert _same_bits(dense_assemble(*parts, pair_major=pair_major), got)


def _readme_solve(dev, dtype, k, centers, **kw):
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave

    f = dict(dtype=dtype, device=dev)
    kt = torch.as_tensor(k, device=dev)
    kt = kt.to(torch.complex128 if dtype == torch.float64 else torch.complex64) \
        if kt.is_complex() else kt.to(dtype)
    centers = torch.as_tensor(centers, **f)
    n_k = kt.numel()
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    if kt.ndim:
        direction = direction[:, None].expand(3, n_k)
    uin, _ = plane_wave(k=kt, direction=direction)
    calc = biem(create_from_branching_types("ba"), centers=centers,
                radii=torch.ones(centers.shape[:-1], **f), k=kt, n_end=8, uin=uin, **kw)
    return calc.density.cpu(), calc.uscat(torch.zeros(3, 1, **f)).cpu()


@pytest.mark.requires_cuda
def test_complex_k_factored_solve_on_the_card_matches_the_cpu(cuda):
    """A complex-k solve on the factored route (K5, K2, KB, KC, KA's
    few-point mode) against the same call on the CPU."""
    k = np.array([1.0 + 0.1j, 1.5 + 0.2j])
    centers = np.broadcast_to(_lattice(2, 4.0), (2, 4, 3)).copy()
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        got = _readme_solve(cuda, dtype, k, centers, solver="matfree", stable=True)
        ref = _readme_solve(torch.device("cpu"), dtype, k, centers, solver="matfree",
                            stable=True)
        for g, r in zip(got, ref):
            assert _rel(g, r) < tol


@pytest.mark.requires_cuda
def test_batch_geometry_lu_solve_on_the_card_matches_the_cpu(cuda):
    """Geometry along the batch (two pitches) on the LU route (KD per k)
    against the same call on the CPU."""
    centers = np.stack([_lattice(2, 4.0), _lattice(2, 5.0)])
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        got = _readme_solve(cuda, dtype, np.array([1.2, 1.4]), centers)
        ref = _readme_solve(torch.device("cpu"), dtype, np.array([1.2, 1.4]), centers)
        for g, r in zip(got, ref):
            assert _rel(g, r) < tol


def _coax_inputs(cuda, rdt, n_end, ks, r):
    """K2's inputs as the factored operator makes them on the card, for
    wavenumbers ks and pair distances r."""
    c = create_from_branching_types("ba")
    n_k = len(ks)
    f = dict(dtype=rdt, device=cuda)
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    k = torch.as_tensor(ks, **f)
    (_, _), (_, e_r), (_, e_b) = _radial_rows_scaled(
        c, n_end, torch.ones(n_k, 2, **f), k, torch.ones(n_k, **f),
        torch.ones(n_k, 2, dtype=cdt, device=cuda), torch.zeros(n_k, 2, dtype=cdt, device=cuda),
    )
    starts = torch.as_tensor(np.searchsorted(basis(c, n_end).n_root, np.arange(n_end)),
                             device=cuda)
    e_r, e_b = (e.amax(dim=-2)[:, starts].contiguous() for e in (e_r, e_b))
    r = torch.as_tensor(r, **f)
    radm, rade = special.spherical_h_scaled(3, 2 * n_end - 1, k[:, None] * r)
    return radm, rade, e_r, e_b, _coax_packed(c, n_end, rdt, cuda)


# (n_end, k, distances) of the K2 cases: the bench block (4 k x 9 radii);
# past the float32 overflow wall (k t = 4, n_end = 24: S > 88); pair
# counts that fill no pass (1 and 21 pairs) and one that takes two in
# both dtypes (45 pairs); 85 packed entries (ragged tiles); one band
# group (n_end = 2); ten (n_end = 40)
_COAX_CASES = {
    "bench": (32, np.linspace(7.0, 7.06, 4), _pair_routing(_lattice()).uniq_r),
    "overflow-wall": (24, np.array([1.0]), np.array([4.0])),
    "1k-1r": (32, np.array([7.0]), np.array([4.0])),
    "3k-7r": (32, np.array([6.0, 7.0, 8.5]), np.linspace(4.0, 13.0, 7)),
    "5k-9r": (32, np.linspace(7.0, 7.08, 5), _pair_routing(_lattice()).uniq_r),
    "85-entries": (5, np.array([1.5, 3.0]), np.array([4.0, 6.0, 9.0])),
    "n_end-2": (2, np.array([1.0, 2.0]), np.array([4.0, 5.0])),
    "n_end-40": (40, np.linspace(7.0, 7.06, 4), np.array([4.0, 8.0, 12.0])),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_COAX_CASES))
def test_coax_fold_kernel_matches_plain(cuda, dtype, case):
    """K2 against its plain version on the card at each of _COAX_CASES;
    one launch per call, and two launches are bit for bit equal."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    n_end, ks, r = _COAX_CASES[case]
    args = _coax_inputs(cuda, rdt, n_end, ks, r)
    n0 = coax_fold.launches
    got = coax_fold(*args)
    ref = _coax_fold_packed_plain(*args)
    assert coax_fold.launches == n0 + 1
    assert got.shape == ref.shape and bool(torch.isfinite(ref).all())
    assert float((got - ref).abs().max() / ref.abs().max()) < _tol(dtype)
    assert _same_bits(coax_fold(*args), got)


# KU's cases (tree, n_end): chip_smoke.py phase 2's (i) phase 8 (a)'s 4D
# first block, (ii) the bench's, (iii) 'ba' at 64 (every band group in one
# pass), (iv) the 5D pair's and (v) 'ba' at 96 (two passes: no size ceiling)
_KU_CASES = {"bba-20": ("bba", 20), "ba-32": ("ba", 32), "ba-64": ("ba", 64),
             "bbba-8": ("bbba", 8), "ba-96": ("ba", 96)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(_KU_CASES))
def test_coax_u_kernel_matches_plain(cuda, dtype, case):
    """KU against its plain version on the card: each entry of u and of the
    tile image within 1e-14 of its sum of magnitudes sum_q |tz w t_a t_b|
    (and, in float32, within one rounding of the plain value), exactly 0
    wherever that sum is (bands above l + l', slots past a ragged tile);
    one launch per call, and two launches are bit for bit equal."""
    tree, n_end = _KU_CASES[case]
    c = create_from_branching_types(tree)
    layout, plan = _coax_plan_on(c, n_end, cuda)[:2]
    t, tzw = _coax_tables_on(c, n_end, cuda)
    n0 = coax_u.launches
    got = coax_u((t, tzw), layout, plan, dtype)
    assert coax_u.launches == n0 + 1
    ref = _coax_u_plain((t, tzw), layout, plan, dtype)
    mag = _coax_u_plain((t.abs(), tzw.abs()), layout, plan, torch.float64)
    rel = 2.0 ** -23 if dtype == torch.float32 else 0.0
    for g, r, m in zip(got, ref, mag):
        assert g.shape == r.shape and g.dtype == dtype
        d = (g.double() - r.double()).abs()
        assert bool((d <= 1e-14 * m + rel * r.double().abs()).all())
        assert bool((g[m == 0] == 0).all())
    assert _same_bits(coax_u((t, tzw), layout, plan, dtype), got)


@pytest.mark.requires_cuda
def test_factored_operator_on_the_card_matches_the_cpu(cuda):
    """The k-dependent build (K5 x 2 + K2) and the matvec on the card agree
    with the CPU in float64, and the build launched its kernels."""
    n_end, n_k = 8, 2
    centers = _lattice()
    nb = len(centers)
    rng = np.random.default_rng(28)
    x = _randc(rng, (n_k, nb * n_end * n_end))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        f = dict(dtype=torch.float64, device=dev)
        counts = (spherical_jh.launches, coax_fold.launches)
        mv, diag = _factored_operator(
            create_from_branching_types("ba"), n_end, centers, torch.ones(n_k, nb, **f),
            torch.tensor([1.3, 2.1], **f), torch.ones(n_k, **f),
            torch.ones(n_k, nb, dtype=torch.complex128, device=dev),
            torch.zeros(n_k, nb, dtype=torch.complex128, device=dev),
        )
        launched = (spherical_jh.launches - counts[0], coax_fold.launches - counts[1])
        assert launched == ((0, 0) if dev.type == "cpu" else (2, 1))
        out[dev.type] = (mv(torch.as_tensor(x, device=dev)).cpu(), diag.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-10


@pytest.mark.requires_cuda
def test_offset_table_operator_on_the_card_matches_the_cpu(cuda):
    """The unscaled offset-table operator (K5, K2's zero-exponent mode, the
    sandwich, then the KC gather, the batched table product and the KC
    scatter per matvec) on the card agrees with the CPU in complex128, per
    (k, sphere, degree) block, and never launches KB."""
    n_end, n_k = 8, 2
    centers = _lattice()
    nb = len(centers)
    rng = np.random.default_rng(29)
    x = _randc(rng, (n_k, nb * n_end * n_end))
    n_root = basis(create_from_branching_types("ba"), n_end).n_root
    out = {}
    for dev in (torch.device("cpu"), cuda):
        f = dict(dtype=torch.float64, device=dev)
        counts = (spherical_jh.launches, coax_fold.launches, lane_gather.launches,
                  lane_scatter.launches, block_diag_cmm.launches)
        mv, diag = _matfree_operator(
            create_from_branching_types("ba"), n_end, centers, torch.ones(n_k, nb, **f),
            torch.tensor([1.3, 2.1], **f), torch.ones(n_k, **f),
            torch.ones(n_k, nb, dtype=torch.complex128, device=dev),
            torch.full((n_k, nb), 0.5, dtype=torch.complex128, device=dev),
        )
        y = mv(torch.as_tensor(x, device=dev))
        launched = tuple(w.launches - n for w, n in zip(
            (spherical_jh, coax_fold, lane_gather, lane_scatter, block_diag_cmm), counts))
        assert launched == ((0,) * 5 if dev.type == "cpu" else (2, 1, 1, 1, 0))
        out[dev.type] = (y.cpu(), diag.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        d = (a - b).abs().reshape(n_k, nb, -1)
        r = b.abs().reshape(d.shape)
        for ell in np.unique(n_root):
            sel = torch.as_tensor(n_root == ell)
            assert float((d[..., sel].amax(-1) / r[..., sel].amax(-1)).max()) <= 1e-12


def _gather_case(case, cuda, dtype, rng):
    """(x, blc, pm, route) for the KC gather tests."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    if case == "empty-and-crowded":
        nb, n_end = 3, 5
        src = np.array([4, 0, 4, 4, 2, 4, 0, 5, 4, 3, 4])  # source row 1 has no lane
        dst = rng.integers(0, nb, size=len(src))
        route = make_route(src, dst, src >= nb, nb, cuda)
    else:
        centers = _lattice()
        nb, n_end = len(centers), (32 if case == "bench" else 5)
        rt = _pair_routing(centers)
        route = make_route(rt.src, rt.dst, rt.dn, nb, cuda)
    h = n_end * n_end
    pm = torch.as_tensor((-1.0) ** (basis(create_from_branching_types("ba"), n_end).n_root % 2),
                         dtype=rdt, device=cuda)
    x, blc = (torch.as_tensor(_randc(rng, (4, nb, h)), dtype=dtype, device=cuda)
              for _ in range(2))
    return x, blc, pm, route


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["bench", "empty-and-crowded", "odd-H"])
def test_lane_gather_by_source_kernel(cuda, dtype, case):
    """The KC gather (a CTA per chunk x source row x k over the by-source
    CSR) against _lane_gather_plain on the bench routing, on one where a
    source row has no lane and one has many, and at an odd H (n_end = 5,
    H = 25: complex64 rows start off 16 bytes); also with x at an odd
    element offset; two launches bit for bit."""
    rng = np.random.default_rng(44)
    x, blc, pm, route = _gather_case(case, cuda, dtype, rng)
    n0 = lane_gather.launches
    got = lane_gather(x, blc, pm, route)
    assert lane_gather.launches == n0 + 1
    ref = _lane_gather_plain(x, blc, pm, route)
    assert got.shape == ref.shape and _rel(got, ref) < _tol(dtype)
    assert _same_bits(lane_gather(x, blc, pm, route), got)
    # x contiguous but one element off its allocation (off 16 bytes in complex64)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous()
    assert _same_bits(lane_gather(shifted, blc, pm, route), got)


@pytest.mark.requires_cuda
def test_kernels_launch_on_the_current_stream(cuda):
    """kernels.launch takes the stream handle torch.cuda.current_stream()
    gives, on the default stream and under a side stream; the KC gather
    and K5 launched on a side stream, behind a copy that a sleep on that
    stream delays, read the copied inputs and give the default stream's
    bits."""
    assert kernels.current_stream_handle() == torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(45)
    x, blc, pm, route = _gather_case("bench", cuda, torch.complex64, rng)
    z = torch.as_tensor(_Z, dtype=torch.complex64, device=cuda).reshape(-1, 1)
    ref = (lane_gather(x, blc, pm, route), spherical_jh(_SCALED, 3, 32, z))
    xs, zs = torch.zeros_like(x), torch.zeros_like(z)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        handle = kernels.current_stream_handle()
        assert handle == torch.cuda.current_stream().cuda_stream == side.cuda_stream
        assert handle != torch.cuda.default_stream(cuda).cuda_stream
        torch.cuda._sleep(100_000_000)
        xs.copy_(x)
        zs.copy_(z)
        got = (lane_gather(xs, blc, pm, route), spherical_jh(_SCALED, 3, 32, zs))
    torch.cuda.current_stream().wait_stream(side)
    assert _same_bits(got, ref)


# (centers, radii, n_end) of the KD cases: the 4x4 lattice (uniform radii,
# 24 distinct offsets) at an even and an odd H, and 3 spheres of different
# radii (the ball deficits on the row and column factors)
_DENSE_CASES = {
    "lattice-uniform": (_lattice(), np.ones(16), 8),
    "lattice-odd-H": (_lattice(), np.ones(16), 5),
    "three-radii": (np.array([[0.3, -0.2, 0.1], [4.1, 1.0, -0.6], [-1.2, 3.9, 2.2]]),
                    np.array([0.9, 1.2, 0.7]), 8),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pair_major", [True, False])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("case", list(_DENSE_CASES))
def test_dense_assemble_kernel_matches_plain(cuda, dtype, pair_major, stable, case):
    """KD against its plain version on the card, on the assembly's own
    arguments (plain and stable, both layouts); one launch per call, and
    two launches are bit for bit equal.  The kernel forms each entry by the
    plain version's products in its order, so the two are equal entry for
    entry: the entries span many orders of magnitude (~(rho/t)^(n+n') off
    the diagonal), and a tolerance relative to the largest one would pass a
    kernel that spoils the high-degree rows and columns."""
    centers, radii, n_end = _DENSE_CASES[case]
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=cuda)
    n_b = len(radii)
    ks = torch.tensor([1.3, 2.1], **f)
    parts = _assembly_parts(
        create_from_branching_types("ba"), n_end, centers,
        torch.as_tensor(np.broadcast_to(radii, (2, n_b)).copy(), **f), ks,
        torch.tensor([1.0, 0.7], **f), torch.ones(2, n_b, dtype=dtype, device=cuda),
        torch.full((2, n_b), 0.3, dtype=dtype, device=cuda), stable=stable)
    n0 = dense_assemble.launches
    got = dense_assemble(*parts, pair_major=pair_major)
    assert dense_assemble.launches == n0 + 1
    ref = _dense_assemble_plain(*parts, pair_major)
    assert got.shape == ref.shape and bool(torch.isfinite(ref).all())
    assert torch.equal(got, ref), _rel(got, ref)
    assert _same_bits(dense_assemble(*parts, pair_major=pair_major), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("kind", ["SR", "RR"])
def test_coax_fold_zero_exponent_mode_is_coaxial_sr(cuda, dtype, kind):
    """K2 with zero exponents (coaxial_sr on the card) against the plain
    coaxial_sr formula on the same K5 band values, at the bench's 9 radii
    x 4 k (n_end = 19, the LU tier) and at n_end = 8."""
    from biem_helmholtz_sphere_tpu_torch.special import spherical_jh_all

    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    c = create_from_branching_types("ba")
    r = torch.as_tensor(_pair_routing(_lattice()).uniq_r, dtype=rdt, device=cuda)
    k = torch.linspace(7.0, 7.06, 4, dtype=rdt, device=cuda)[:, None]
    for n_end in (19, 8):
        n0 = coax_fold.launches
        got = coaxial_sr(c, r, n_end, k, kind=kind)
        assert coax_fold.launches == n0 + 1
        j, _, h, _ = spherical_jh_all(3, 2 * n_end - 1, (k * r).reshape(1, -1))
        ref = _coaxial_sr_plain(c, h if kind == "SR" else j, n_end).reshape(got.shape)
        assert bool(torch.isfinite(ref).all())
        # per (degree, degree) block, where magnitudes are alike
        ell = torch.as_tensor(basis(c, n_end).n_root, device=cuda)
        for lr in range(n_end):
            for lc in range(n_end):
                blk = (ell == lr)[:, None] & (ell == lc)[None, :]
                g, e = got[..., blk], ref[..., blk]
                scale = e.abs().amax(dim=-1, keepdim=True).clamp_min(torch.finfo(rdt).tiny)
                assert float(((g - e).abs() / scale).max()) < _tol(dtype), (n_end, lr, lc)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.requires_cuda
def test_kernels_launch_on_the_operands_device(two_cards):
    """With card 0 current, kernels on card 1's tensors run on card 1 (its
    current stream) and give card 0's bits; operands on two cards raise;
    the K2 tables of a bare "cuda" are the current card's."""
    dev0, dev1 = two_cards
    rng = np.random.default_rng(46)
    x, blc, pm, route = _gather_case("bench", dev0, torch.complex64, rng)
    route1 = make_route(*(t.cpu().numpy() for t in (route.src, route.dst, route.dn)),
                        route.n_balls, dev1)
    z = torch.as_tensor(_Z, dtype=torch.complex64).reshape(-1, 1)
    assert torch.cuda.current_device() == 0
    ref = (lane_gather(x, blc, pm, route), spherical_jh(_SCALED, 3, 32, z.to(dev0)))
    got = (lane_gather(x.to(dev1), blc.to(dev1), pm.to(dev1), route1),
           spherical_jh(_SCALED, 3, 32, z.to(dev1)))
    torch.cuda.synchronize(dev1)
    assert all(t.device == dev1 for t in (got[0], *got[1][0]))
    assert _same_bits(tuple(t.to(dev0) for t in (got[0], *got[1][0])),
                      (ref[0], *ref[1][0]))
    with pytest.raises(RuntimeError, match="different devices"):
        lane_gather(x, blc.to(dev1), pm, route)
    c = create_from_branching_types("ba")
    with torch.cuda.device(1):
        tab = _coax_packed(c, 6, torch.float32, "cuda")
    assert tab.u.device == dev1


def _hypercube(half=2.0, d=4):
    return np.stack(np.meshgrid(*([[-half, half]] * d), indexing="ij"), axis=-1).reshape(-1, d)


def _pair(d):
    centers = np.zeros((2, d))
    centers[0, 1], centers[1, 1] = 2.0, -2.0
    return centers


_PANEL_CASES = {
    # name: (d, n_end, centers): D's degree blocks up to 400, 256, 204
    "4d-hypercube-20": (4, 20, _hypercube()),
    "4d-hypercube-16": (4, 16, _hypercube()),
    "5d-pair-8": (5, 8, _pair(5)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("adjoint", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_PANEL_CASES))
def test_block_diag_cmm_row_panels_match_plain(cuda, case, dtype, adjoint):
    """KB's row-panel mode (degree blocks of D too large to stage whole) on
    the factored route's compacted lanes, 4 k, against the plain version,
    and a second launch equal bit for bit."""
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import pack_layout

    d, n_end, centers = _PANEL_CASES[case]
    rng = np.random.default_rng(31)
    rt = _pair_routing(centers)
    sizes = [harm_n_ndim(n, d) for n in range(n_end)]
    h = sum(sizes)
    a = pack_layout(sizes, None, h, cuda)
    a = replace(a, vals=torch.as_tensor(_randc(rng, (len(rt.uniq), a.rows.numel())),
                                        dtype=dtype, device=cuda))
    x = torch.as_tensor(_randc(rng, (4, len(rt.src), h)), dtype=dtype, device=cuda)
    seg = LaneSegments(tuple(int(v) for v in rt.slot_ptr))
    n0 = block_diag_cmm.panel_launches
    got = block_diag_cmm(a, x, seg, adjoint=adjoint)
    assert block_diag_cmm.panel_launches == n0 + 1
    assert _same_bits(block_diag_cmm(a, x, seg, adjoint=adjoint), got)
    ref = _block_diag_cmm_plain(unpack(a), x, seg, adjoint)
    assert _rel(got, ref) < _tol(dtype)


def _solve_nd(device, btype, rdt, centers, n_end, k, **kw):
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave

    c = create_from_branching_types(btype)
    f = dict(dtype=rdt, device=device)
    kt = torch.as_tensor(k, **f)
    direction = torch.zeros(c.c_ndim, **f)
    direction[0] = 1.0
    uin, _ = plane_wave(k=kt, direction=direction)
    calc = biem(c, centers=torch.as_tensor(centers, **f),
                radii=torch.ones(len(centers), **f), k=kt, n_end=n_end, uin=uin, **kw)
    x = torch.zeros(c.c_ndim, 1, **f)
    x[0] = 3.0
    return calc.density.cpu(), calc.uscat(x).cpu()


@pytest.mark.requires_cuda
def test_4d_factored_solve_on_the_card_matches_the_cpu(cuda):
    """'bba' on the 4D hypercube at n_end=11 (degree blocks up to 121: KB's
    row panels in both dtypes) on the factored route against the same call
    on the CPU."""
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        n0 = block_diag_cmm.panel_launches
        got = _solve_nd(cuda, "bba", dtype, _hypercube(), 11, 1.5, solver="matfree",
                        stable=True)
        assert block_diag_cmm.panel_launches > n0
        ref = _solve_nd(torch.device("cpu"), "bba", dtype, _hypercube(), 11, 1.5,
                        solver="matfree", stable=True)
        for g, r in zip(got, ref):
            assert _rel(g, r) < tol


@pytest.mark.requires_cuda
def test_5d_lu_solve_on_the_card_matches_the_cpu(cuda):
    """'bbba', the 5D pair at n_end=6, on the LU route (KD) against the
    same call on the CPU."""
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        got = _solve_nd(cuda, "bbba", dtype, _pair(5), 6, 1.0)
        ref = _solve_nd(torch.device("cpu"), "bbba", dtype, _pair(5), 6, 1.0)
        for g, r in zip(got, ref):
            assert _rel(g, r) < tol


def _square_lattice(n_side, d, spacing=4.0):
    """The `n_balls` family's lattice: n_side^2 centers in the (x0, x1) plane."""
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0], centers[:, 1] = xx.ravel(), yy.ravel()
    return centers


def _graf_inputs(device, dtype, n_side, n_end, n_add, n_k, per_k_theta, fold):
    """KG's arguments at the half offsets of an n_side^2 2D lattice: K5's
    d = 2 h (scaled in fold mode, with ball-max-sized row and column
    exponents) at k|t|, the offsets' angles, the signed orders."""
    from biem_helmholtz_sphere_tpu_torch.biem._lattice import _half_offsets, lattice_routing
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_node_m

    rdt = kernels.REAL_OF[dtype]
    c = create_from_branching_types("a")
    _, _, t = _half_offsets(lattice_routing(_square_lattice(n_side, 2)), 2)
    t = torch.as_tensor(t, dtype=rdt, device=device)
    r, theta = torch.linalg.vector_norm(t, dim=1), torch.atan2(t[:, 1], t[:, 0])
    k = torch.linspace(0.9, 1.3, n_k, dtype=rdt, device=device)
    if per_k_theta:  # each k its own angles (geometry along the batch)
        theta = theta[None] + 0.01 * torch.arange(n_k, dtype=rdt, device=device)[:, None]
    else:
        theta = theta[None]
    m_out = torch.as_tensor(_a_node_m(c, n_end), device=device)
    m_in = torch.as_tensor(_a_node_m(c, n_add), device=device)
    n_mu = n_end + n_add - 1
    z = k[:, None] * r
    if not fold:
        return special.spherical_jh_all(2, n_mu, z)[2], theta, m_out, m_in, None, None, None
    hm, he = special.spherical_h_scaled(2, n_mu, z)
    gen = torch.Generator(device="cpu").manual_seed(3)
    e_r = -20.0 * torch.rand(n_k, len(m_out), generator=gen, dtype=rdt).to(device)
    e_b = -20.0 * torch.rand(n_k, len(m_in), generator=gen, dtype=rdt).to(device)
    return hm, theta, m_out, m_in, he, e_r, e_b


# name: (lattice side, n_end, n_end_add, K, per-k angles); n_end = 64 puts
# |mu theta| at up to ~400 rad
_GRAF_CASES = {
    "16x16-n16": (16, 16, 16, 1, False),
    "8x8-n64": (8, 64, 64, 2, False),
    "8x8-per-k-theta": (8, 12, 12, 3, True),
    "8x8-n_end_add": (8, 9, 13, 2, False),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fold", [True, False], ids=["fold", "zero-exponent"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_GRAF_CASES))
def test_graf_fold_kernel_matches_plain(cuda, case, dtype, fold):
    """KG against its plain version on the same card inputs, entry by entry
    relative to each entry's modulus (the two take the same sincos and exp
    of the same real arguments, up to their last-place rounding); two
    launches are bit for bit equal."""
    from biem_helmholtz_sphere_tpu_torch.ops.graf import _graf_fold_plain, graf_fold

    n_side, n_end, n_add, n_k, per_k = _GRAF_CASES[case]
    tab, theta, m_out, m_in, e_tab, e_r, e_b = _graf_inputs(
        cuda, dtype, n_side, n_end, n_add, n_k, per_k, fold)
    n0 = graf_fold.launches
    got = graf_fold(tab, theta, m_out, m_in, e_tab, e_r, e_b)
    assert graf_fold.launches == n0 + 1
    torch.cuda.synchronize()
    ref = _graf_fold_plain(tab, e_tab, theta, m_out, m_in, e_r, e_b)
    assert got.shape == ref.shape == (n_k, tab.shape[1], len(m_out), len(m_in))
    # unscaled complex64 h_n overflows from n ~ k|t| + 20 (zero-exponent mode
    # at n_end = 64): the kernel keeps the same entries finite
    keep = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), keep)
    tiny = torch.finfo(kernels.REAL_OF[dtype]).tiny
    rel = float(((got - ref).abs() / ref.abs().clamp_min(tiny))[keep].max())
    assert rel < (1e-5 if dtype == torch.complex64 else 1e-13), rel
    assert _same_bits(graf_fold(tab, theta, m_out, m_in, e_tab, e_r, e_b), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_spherical_h_d2_at_the_lattice_offsets(cuda, dtype):
    """K5's base-2 mode at d = 2 (base 2, no shift: its m = 0 edge case), h
    alone and unscaled, at the 64 x 64 lattice's 8,128 half offsets and
    63 orders (KG's inputs at n_end = 32), against the plain versions."""
    rdt = kernels.REAL_OF[dtype]
    from biem_helmholtz_sphere_tpu_torch.biem._lattice import _half_offsets, lattice_routing

    _, _, t = _half_offsets(lattice_routing(_square_lattice(64, 2)), 2)
    z = torch.as_tensor(np.linalg.norm(t, axis=1), dtype=rdt, device=cuda).to(dtype)
    got = spherical_jh(_H_ONLY, 2, 63, z)
    assert _scaled_rel(got, _spherical_h_scaled_plain(2, 63, z)) < _tol(dtype)
    assert _same_bits(spherical_jh(_H_ONLY, 2, 63, z), got)
    got = spherical_jh(_UNSCALED, 2, 21, z)[2]
    ref = _spherical_jh_all_plain(2, 21, z)[2]
    assert float(((got - ref).abs() / ref.abs()).max()) < _tol(dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("btype", ["a", "ba"])
def test_lattice_solve_on_the_card_matches_the_cpu(cuda, btype):
    """The lattice-FFT route (8 x 8 lattice, solver="auto") on the card
    against the same call on the CPU: 'a' at n_end = 12 through KG, 'ba'
    at n_end = 5 through K2, both dtypes, stable and plain.  float64: the
    card's density and uscat within 1e-9 of the CPU's.  float32 (GMRES to
    its 3e-5 residual): the card's within 1e-4 of the CPU's float32 solve,
    or within a fifth of that solve's own distance from the float64 one
    where that is larger, and no further from the float64 solve than the
    CPU's float32 solve is, plus 1e-4.  On the 2D lattice both float32
    solves are 6e-4-1.7e-3 off float64 at k = 1 (within 7% of each other)
    and two correct float32 solves differ by up to 1.07e-4 with the
    ulp-level bits of their inputs; card against CPU reads at most 0.07 of
    that distance, in 3D at most 0.01 (tools/torch_lattice_f32.py)."""
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.ops.graf import graf_fold

    d = 2 if btype == "a" else 3
    n_end = 12 if btype == "a" else 5
    centers = _square_lattice(8, d)
    assert _core._route("auto", 64, 64 * 9, torch.float64, cuda, True, False,
                        centers) == "lattice"
    for stable in (True, False):
        exact = _solve_nd(torch.device("cpu"), btype, torch.float64, centers, n_end, 1.0,
                          stable=stable)
        for dtype in (torch.float64, torch.float32):
            n0 = graf_fold.launches
            got = _solve_nd(cuda, btype, dtype, centers, n_end, 1.0, stable=stable)
            assert (graf_fold.launches > n0) == (btype == "a")
            ref = exact if dtype == torch.float64 else _solve_nd(
                torch.device("cpu"), btype, dtype, centers, n_end, 1.0, stable=stable)
            for g, r, e in zip(got, ref, exact):
                if dtype == torch.float64:
                    assert _rel(g, r) < 1e-9
                else:
                    g, r = g.to(e.dtype), r.to(e.dtype)
                    assert _rel(g, r) < max(1e-4, 0.2 * _rel(r, e))
                    assert _rel(g, e) <= _rel(r, e) + 1e-4


def _block_rel(got, ref, n_o, n_i, floor=0.0):
    """Largest error relative to the largest |ref| of each (leading index,
    row degree, column degree) block: across blocks the (S|R) entries span
    many orders of magnitude.  A block below `floor` times its matrix's
    largest |ref| is held against that instead."""
    assert bool(torch.isfinite(got).all())
    err = 0.0
    big = floor * ref.abs().amax(dim=(-2, -1))
    for a in np.unique(n_o):
        for b in np.unique(n_i):
            g, r = got[..., n_o == a, :][..., n_i == b], ref[..., n_o == a, :][..., n_i == b]
            d = (g - r).abs().amax(dim=(-2, -1))
            m = torch.maximum(r.abs().amax(dim=(-2, -1)), big).clamp_min(torch.finfo(d.dtype).tiny)
            err = max(err, float((d / m).max()))
    return err


# name: (tree, n_out, n_in, offsets, K, per-k directions); KS serves 4
# offsets a CTA, so K NO = 6, 2 or 1 leaves a CTA part empty
_BAND_CASES = {
    "caa-n8": ("caa", 8, 8, 3, 2, False),
    "caa-per-k-directions": ("caa", 6, 6, 2, 3, True),
    "caa-n_end_add": ("caa", 5, 7, 2, 1, False),
    "ba-triplet-n9": ("ba", 9, 9, 2, 2, False),
    "bcaa-n4": ("bcaa", 4, 4, 2, 1, False),
    "cbaba-n3": ("cbaba", 3, 3, 2, 2, False),
    # blocks of 1 and 4 rows (below the 16-row M-tile), H = 5, K NO = 1
    "caa-n2-one-offset": ("caa", 2, 2, 1, 1, False),
    # phase 10 (e)'s shape: H = 385 (not a multiple of 8 nor of 128 columns),
    # Q = 15,884 (not a multiple of the 8- or 16-node chunk)
    "caa-n10": ("caa", 10, 10, 4, 2, False),
    # n_out != n_in at per-k directions: two tables, a row group with one slot
    "caa-n_end_add-per-k": ("caa", 3, 9, 3, 2, True),
}


def _band_inputs(case, dtype, mode, dev):
    """(coef, t_hat, tables, extra arguments) of a _BAND_CASES case in a
    mode: "unscaled" (h), "scaled" (h's mantissas with the band
    exponents), "fold" (those and the row and column exponents),
    "fold-extreme" (band exponents he_n = -100 + 40 n / (NB - 1) and row
    and column exponents in [45, 50]: each beyond float32's exp on its
    own, their sums in [-10, 40]), or "clamp" (he_n = 40 - 82 n / (NB - 1):
    band differences up to 82, past the clamp at 80; KF only, since the
    magnified low bands leave the table's blocks they do not reach as
    rounding noise, float32 1e8 off its float64 self per block)."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import band_coefs
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts, _quad_tables

    tree, n_out, n_in, n_off, n_k, per_k = _BAND_CASES[case]
    rdt = kernels.REAL_OF[dtype]
    c = create_from_branching_types(tree)
    d = c.c_ndim
    tab = _quad_tables(c, n_out, n_in, rdt, dev)
    rng = np.random.default_rng(41)
    t = rng.normal(size=(n_k if per_k else 1, n_off, d))
    r = 3.0 + rng.random(size=(n_k, n_off))
    f = dict(dtype=rdt, device=dev)
    t_hat = torch.as_tensor(t / np.linalg.norm(t, axis=-1, keepdims=True), **f)
    k = torch.linspace(0.8, 1.6, n_k, **f)
    hm, he = spherical_h_scaled(d, tab.n_bands, k[:, None] * torch.as_tensor(r, **f))
    if mode == "unscaled":
        return band_coefs(hm * torch.exp(he), d, *_band_consts(d)), t_hat, tab, ()
    n_b = tab.n_bands
    ramp = torch.arange(n_b, **f) / max(n_b - 1, 1)
    if mode in ("fold-extreme", "clamp"):
        he = ((-100.0 + 40.0 * ramp) if mode == "fold-extreme" else (40.0 - 82.0 * ramp))
        he = he.expand(n_k, n_off, n_b).contiguous()
    coef = band_coefs(hm, d, *_band_consts(d), he=he)
    if mode == "scaled":
        return coef, t_hat, tab, ()
    e_r, e_b = (torch.as_tensor(rng.random((n_k, h)) * 5, **f)
                for h in (tab.yo.shape[1], tab.yi.shape[1]))
    if mode == "fold-extreme":
        return coef, t_hat, tab, (he, e_r + 45.0, e_b + 45.0)
    return coef, t_hat, tab, (he, -e_r, -e_b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["unscaled", "scaled", "fold", "fold-extreme"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_BAND_CASES))
def test_band_sr_kernel_matches_plain(cuda, case, dtype, mode):
    """KS against its plain version on the same card inputs in its modes
    (h unscaled, h's mantissas with the band exponents, those with the row
    and column exponents folded in, and the fold at exponents that only
    sum to a finite float32 exp), per degree block (complex64 1e-4, complex128 1e-11: both sum
    the nodes in another order); KF once and KS once (one group of
    offsets); two launches are bit for bit equal."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_sr_plain, band_f, band_sr

    coef, t_hat, tab, args = _band_inputs(case, dtype, mode, cuda)
    n_k, n_off = coef.shape[:2]
    n0, f0 = band_sr.launches, band_f.launches
    got = band_sr(coef, t_hat, tab, *args)
    assert band_sr.launches == n0 + 1 and band_f.launches == f0 + 1
    torch.cuda.synchronize()
    ref = _band_sr_plain(coef, t_hat, tab, *args)
    assert got.shape == ref.shape == (n_k, n_off, tab.yo.shape[1], tab.yi.shape[1])
    err = _block_rel(got, ref, tab.n_o_host, tab.n_i_host)
    assert err < (1e-4 if dtype == torch.complex64 else 1e-11), err
    assert _same_bits(band_sr(coef, t_hat, tab, *args), got)


def _kf_inputs(n_b, dtype, dev):
    """(coef [2, 3, NB, NB], t_hat [2, 3, 4] per-k directions, nodes) of KF
    at n_b bands on 'caa': the band scan's product rule for NB bands (exact
    to degree 2 (NB - 1), at most 64: KF needs no exact rule), coefficients
    from h's mantissas with their band exponents (the scaled modes') at k
    |t| in [3, 5]."""
    from types import SimpleNamespace

    from biem_helmholtz_sphere_tpu_torch.coords import to_cartesian
    from biem_helmholtz_sphere_tpu_torch.harmonics._quad import sphere_quadrature
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import band_coefs
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts

    c = create_from_branching_types("caa")
    rdt = kernels.REAL_OF[dtype]
    sph, w = sphere_quadrature(c, min(2 * (n_b - 1), 64))
    sph_t = {key: torch.as_tensor(v, dtype=torch.float64, device=dev) for key, v in sph.items()}
    nodes = SimpleNamespace(w=torch.as_tensor(w, dtype=rdt, device=dev),
                            s_cart=to_cartesian(c, sph_t, include_r=False).to(rdt),
                            q_pad=-(-len(w) // 16) * 16)
    rng = np.random.default_rng(43)
    t = rng.normal(size=(2, 3, 4))
    t_hat = torch.as_tensor(t / np.linalg.norm(t, axis=-1, keepdims=True), dtype=rdt, device=dev)
    hm, he = spherical_h_scaled(4, n_b, torch.as_tensor(3.0 + 2.0 * rng.random((2, 3)),
                                                        dtype=rdt, device=dev))
    return band_coefs(hm, 4, *_band_consts(4), he=he).contiguous(), t_hat, nodes


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_b", [None, 15, 16, 17, 33])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_band_f_kernel_matches_plain(cuda, dtype, n_b):
    """KF (F_N at every node for a group of offsets) against its plain
    version, the f that `_band_sr_plain` forms, per band N relative to the
    band's largest |F| (complex64 1e-5, complex128 1e-13), zero past Q,
    bits repeated: (None) offsets 3 .. 5 of 6 at per-k directions, with band
    exponents past the clamp at 80; (n_b) offsets 2 .. 4 of 6 at NB bands one
    below, at and one above KF's chunk of 16, and past two chunks (33), on
    node counts not a multiple of KF's tile of 256 but at 16 (8,100 at NB =
    15, 11,560 at 17, 78,408 at 33)."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_f_plain, band_f

    if n_b is None:
        coef, t_hat, tab, _ = _band_inputs("caa-n_end_add-per-k", dtype, "clamp", cuda)
        coef, t_hat, ko0, ko1 = coef.contiguous(), t_hat.contiguous(), 3, 6
    else:
        coef, t_hat, tab = _kf_inputs(n_b, dtype, cuda)
        ko0, ko1 = 2, 5
    n0 = band_f.launches
    got = band_f(coef, t_hat, tab, ko0, ko1)
    assert band_f.launches == n0 + 1
    ref = _band_f_plain(coef, t_hat, tab, ko0, ko1)
    n_q, nb = tab.w.shape[0], coef.shape[2]
    assert got.shape == ref.shape == (ko1 - ko0, nb, tab.q_pad)
    assert not bool(got[..., n_q:].any())
    scale = ref.abs().amax(dim=2, keepdim=True).clamp_min(torch.finfo(ref.real.dtype).tiny)
    err = float(((got - ref).abs() / scale).max())
    assert err < (1e-5 if dtype == torch.complex64 else 1e-13), err
    assert _same_bits(band_f(coef, t_hat, tab, ko0, ko1), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_band_f_kernel_where_its_quotients_are_subnormal(cuda, dtype):
    """KF where the recurrence's quotients fall below the range its
    division without a divide is exact in (x = t^ . s ~ 1e-33 in float32,
    1e-305 in float64: C_1 is that small, subnormal in places): against
    its plain version per band (complex64 1e-5, complex128 1e-13), zero
    past Q, bits repeated."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_f_plain, band_f

    coef, t_hat, tab = _kf_inputs(17, dtype, cuda)
    t_hat = torch.zeros_like(t_hat)
    t_hat[..., 0] = 1e-33 if dtype == torch.complex64 else 1e-305
    got = band_f(coef, t_hat, tab, 2, 5)
    ref = _band_f_plain(coef, t_hat, tab, 2, 5)
    assert not bool(got[..., tab.w.shape[0]:].any())
    scale = ref.abs().amax(dim=2, keepdim=True).clamp_min(torch.finfo(ref.real.dtype).tiny)
    err = float(((got - ref).abs() / scale).max())
    assert err < (1e-5 if dtype == torch.complex64 else 1e-13), err
    assert _same_bits(band_f(coef, t_hat, tab, 2, 5), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_band_sr_kernel_in_offset_groups(cuda, dtype, monkeypatch):
    """K NO = 6 offsets under an F budget of four: groups of 3 and 3 (K NO
    not a multiple of the budget), a KF and a KS launch each; the table
    equals the one-group table bit for bit, and its plain version per
    degree block."""
    from biem_helmholtz_sphere_tpu_torch.ops import band_sr as ks

    coef, t_hat, tab, args = _band_inputs("caa-n_end_add-per-k", dtype, "fold", cuda)
    whole = ks.band_sr(coef, t_hat, tab, *args)
    per = tab.q_pad * tab.n_bands * coef.element_size()
    monkeypatch.setattr(ks, "_F_BYTES", 4 * per)
    assert ks.offset_groups(6, tab.q_pad, tab.n_bands, coef.element_size()) == [(0, 3), (3, 6)]
    n0, f0 = ks.band_sr.launches, ks.band_f.launches
    got = ks.band_sr(coef, t_hat, tab, *args)
    assert ks.band_sr.launches == n0 + 2 and ks.band_f.launches == f0 + 2
    assert _same_bits(got, whole)
    err = _block_rel(got, ks._band_sr_plain(coef, t_hat, tab, *args), tab.n_o_host,
                     tab.n_i_host)
    assert err < (1e-4 if dtype == torch.complex64 else 1e-11), err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["caa-pair", "caa-lattice", "bcaa-pair"])
def test_c_tree_solves_on_the_card_match_the_cpu(cuda, case):
    """Trees with a 'c' node on the card against the same call on the CPU:
    the 'caa' pair on LU, dense GMRES and the offset table (KS in fold and
    unscaled mode), the 8 x 8 'caa' lattice on the lattice route, and the
    'bcaa' pair on the factored route (KB with the 'c' node's blocks) and
    the dense route with "triplet" (KS); both dtypes."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import band_sr

    tree, centers, n_end, calls = {
        "caa-pair": ("caa", np.array([[0.0, 2.0, 0.0, 0.0], [0.0, -2.0, 0.0, 0.0]]), 6, (
            dict(), dict(solver="gmres"), dict(solver="matfree", stable=True),
            dict(solver="matfree", stable=False))),
        "caa-lattice": ("caa", _square_lattice(8, 4), 3, (dict(), dict(stable=False))),
        "bcaa-pair": ("bcaa", np.array([[0.0, 2.0, 0.0, 0.0, 0.0],
                                        [0.0, -2.0, 0.0, 0.0, 0.0]]), 5, (
            dict(solver="matfree", stable=True),
            dict(solver="direct", stable=False, translational_coefficients_method="triplet"))),
    }[case]
    for kw in calls:
        for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
            n0 = band_sr.launches
            got = _solve_nd(cuda, tree, dtype, centers, n_end, 1.0, **kw)
            assert (band_sr.launches > n0) == (kw.get("solver") != "matfree"
                                               or tree != "bcaa")
            ref = _solve_nd(torch.device("cpu"), tree, dtype, centers, n_end, 1.0, **kw)
            for g, r in zip(got, ref):
                assert _rel(g, r) < tol, (kw, dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("kind", ["SR", "RR"])
def test_gd_coaxial_on_the_card_matches_the_cpu(cuda, kind, dtype):
    """The Gumerov ladders on the card (one K5 launch for the radial column
    at 3 n_end + 2 orders) against the same call on the CPU at the bench's
    9 radii x 4 k, n_end = 32, per (k, radius, degree block): complex128
    1e-12 and complex64 2e-4 for SR (the CPU comparison of the two
    packages' float32 ladders shows 4.9e-5 at these shapes).  RR's blocks
    below 1e-3 of the matrix are held against that (the RR ladder forms
    them by cancellation, tests/test_torch_gumerov.py).  At n_end = 32 the
    RR ladder is ill-conditioned: radii one ulp longer move the CPU float64
    matrix by 5.0e-12 per block and the card differs from the CPU by
    5.5e-12 (H100, chip_smoke.py phase 11 (d)), so RR takes 2e-11 in
    complex128; in complex64 the card and the CPU differ by as much as
    either differs from float64 (1.8e-3 and 2.0e-3 there), so RR takes
    5e-3 and the card's error against the float64 CPU matrix must be
    within 2x the CPU float32 matrix's own."""
    from biem_helmholtz_sphere_tpu_torch.translation import gd_coaxial

    c = create_from_branching_types("ba")
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    r = torch.as_tensor(_pair_routing(_lattice()).uniq_r, dtype=rdt)
    k = torch.linspace(7.0, 7.06, 4, dtype=rdt)[:, None]
    n0 = spherical_jh.launches
    got = gd_coaxial(c, r.to(cuda), 32, k.to(cuda), kind=kind).cpu()
    assert spherical_jh.launches == n0 + 1
    ref = gd_coaxial(c, r, 32, k, kind=kind)
    n_root = basis(c, 32).n_root
    floor = 1e-3 if kind == "RR" else 0.0
    tol = {("SR", torch.complex64): 2e-4, ("RR", torch.complex64): 5e-3,
           ("SR", torch.complex128): 1e-12, ("RR", torch.complex128): 2e-11}[kind, dtype]
    assert _block_rel(got, ref, n_root, n_root, floor=floor) <= tol
    if kind == "RR" and dtype == torch.complex64:
        ref64 = gd_coaxial(c, r.double(), 32, k.double(), kind=kind)
        own = _block_rel(ref.to(ref64.dtype), ref64, n_root, n_root, floor=floor)
        assert _block_rel(got.to(ref64.dtype), ref64, n_root, n_root, floor=floor) <= 2.0 * own


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_spherical_jh_at_the_ladders_98_orders(cuda, dtype):
    """K5 unscaled at 98 orders (the ladders' column at n_end = 32) against
    its plain version at kr 4-153: entry by entry where the plain values
    are finite, and non-finite exactly where they are not (float32 h
    overflows at the top orders for kr < ~28).  In complex64 each output
    is also held against the float64 plain version where that is a normal
    float32: within 2x the plain float32 version's own error there (the
    float32 j_n at these orders are far below 1, so the gate relative
    above 1 alone would pass any j)."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    r = torch.as_tensor(_pair_routing(_lattice()).uniq_r, dtype=rdt)
    z = (torch.tensor([[1.0], [7.0], [9.0]], dtype=rdt) * r).to(dtype)
    got = spherical_jh(_UNSCALED, 3, 98, z.to(cuda))
    ref = _spherical_jh_all_plain(3, 98, z)
    ref64 = _spherical_jh_all_plain(3, 98, z.to(torch.complex128))
    tiny = torch.finfo(rdt).tiny
    for g, p, p64 in zip(got, ref, ref64):
        g = g.cpu()
        fin = torch.isfinite(p)
        assert torch.equal(torch.isfinite(g), fin)
        assert float(((g - p).abs() / p.abs().clamp_min(1.0))[fin].max()) < _tol(dtype)
        if dtype == torch.complex64:
            m = fin & (p64.abs() >= tiny)
            own = float(((p.to(p64.dtype) - p64).abs() / p64.abs())[m].max())
            k5 = float(((g.to(p64.dtype) - p64).abs() / p64.abs())[m].max())
            assert k5 <= 2.0 * own, (k5, own)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["lu", "gmres", "offset-table", "lattice"])
def test_gumerov_solves_on_the_card_match_the_cpu(cuda, case):
    """biem(..., translational_coefficients_method="gumerov", stable=False)
    on the card against the same call on the CPU, both dtypes: the 4x4
    lattice on LU (n_end = 8), dense GMRES and the offset table (n_end =
    12), the 8 x 8 lattice on the lattice route (n_end = 5)."""
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import coax_fold as k2

    centers, n_end, kw = {
        "lu": (_lattice(), 8, dict(solver="direct")),
        "gmres": (_lattice(), 12, dict(solver="gmres")),
        "offset-table": (_lattice(), 12, dict(solver="matfree")),
        "lattice": (_square_lattice(8, 3), 5, dict()),
    }[case]
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        n0 = k2.launches
        got = _solve_nd(cuda, "ba", dtype, centers, n_end, 1.5, stable=False,
                        translational_coefficients_method="gumerov", **kw)
        assert k2.launches == n0
        ref = _solve_nd(torch.device("cpu"), "ba", dtype, centers, n_end, 1.5, stable=False,
                        translational_coefficients_method="gumerov", **kw)
        for g, r in zip(got, ref):
            assert _rel(g, r) < tol, (dtype, case)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_radial_surfaces_on_the_card_match_the_cpu(cuda, dtype):
    """regular_singular_component (d = 3 and 4, all four cases) and
    potential_coef (d = 2, 3, 4, S / D x solution / harmonics, real and
    complex k) on the card against the CPU, entry by entry."""
    from biem_helmholtz_sphere_tpu_torch.biem import potential_coef
    from biem_helmholtz_sphere_tpu_torch.harmonics import regular_singular_component

    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    r = torch.linspace(0.5, 3.0, 6, dtype=dtype)
    k = torch.tensor([[0.7], [2.5]], dtype=dtype)
    pairs = []
    for tree in ("ba", "bba"):
        c = create_from_branching_types(tree)
        for typ in ("regular", "singular"):
            for der in (False, True):
                pairs.append((regular_singular_component(c, r.to(cuda), 10, k.to(cuda), typ, der),
                              regular_singular_component(c, r, 10, k, typ, der)))
    n = torch.arange(10)[:, None]
    for d in (2, 3, 4):
        for kk in (k[:, 0], k[:, 0] + 0.2j):
            for der in ("S", "D"):
                for ff in ("solution", "harmonics"):
                    pairs.append((potential_coef(n.to(cuda), d, kk.to(cuda), r[2].to(cuda),
                                                 r[4].to(cuda), der, for_func=ff),
                                  potential_coef(n, d, kk, r[2], r[4], der, for_func=ff)))
    for got, ref in pairs:
        assert got.device.type == "cuda" and got.dtype == cdt
        assert float(((got.cpu() - ref).abs() / ref.abs().clamp_min(1.0)).max()) < _tol(cdt)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["btensorsolve", "shift_nth_row_n_steps",
                                  "orthonormal_jacobi_all"])
def test_surfaces_given_numpy_run_on_the_card(cuda, name):
    """Given numpy (as their JAX counterparts take it) and no tensor, the
    9c surfaces run on the card, and agree with the same call on CPU
    tensors."""
    from biem_helmholtz_sphere_tpu_torch import utils

    rng = np.random.default_rng(13)
    fn, args = {
        "btensorsolve": (utils.btensorsolve, (rng.standard_normal((3, 2, 4, 2, 4))
                                              + 4 * np.eye(8).reshape(2, 4, 2, 4),
                                              rng.standard_normal((3, 2, 4)), 1)),
        "shift_nth_row_n_steps": (utils.shift_nth_row_n_steps,
                                  (rng.standard_normal((2, 5, 7)), -2, -1)),
        "orthonormal_jacobi_all": (special.orthonormal_jacobi_all,
                                   (rng.uniform(-1, 1, (4, 3)), 12, 0.5, 1.5)),
    }[name]
    got = fn(*args)
    assert got.device.type == "cuda"
    ref = fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args))
    assert ref.device.type == "cpu" and got.dtype == ref.dtype
    assert float((got.cpu() - ref).abs().max()) <= 1e-12 * max(float(ref.abs().max()), 1.0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("per_k", [False, True])
def test_dense_assemble_row_window_matches_whole(cuda, dtype, per_k):
    """KD's row window (the row-sharded solve's assembly) equals the rows of
    KD's whole matrix entry for entry, in both of its layouts (the pair-major
    one transposed), and its plain version: windows that cut a ball, K = 2,
    one pair map for both k or one per k; one launch per window, bits
    repeated."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=cuda)
    if per_k:
        geo = np.stack([_lattice(), _lattice(spacing=4.5)[::-1]])
        ks = torch.tensor([1.3 + 0.1j, 2.1 + 0.05j], dtype=dtype, device=cuda)
    else:
        geo = _lattice()
        ks = torch.tensor([1.3, 2.1], **f)
    parts = _assembly_parts(
        create_from_branching_types("ba"), 8, geo, torch.ones(2, 16, **f), ks,
        torch.ones(2, **f), torch.ones(2, 16, dtype=dtype, device=cuda),
        torch.full((2, 16), 0.3, dtype=dtype, device=cuda), stable=True)
    n = 16 * 64
    whole = dense_assemble(*parts).reshape(2, n, n)
    pm = dense_assemble(*parts, pair_major=True).transpose(2, 3).reshape(2, n, n)
    assert torch.equal(whole, pm) and bool(torch.isfinite(whole).all())
    for r0, r1 in ((0, n), (0, n // 2), (n // 2, n), (37, 901), (63, 65), (100, 101),
                   (n - 24, n)):
        n0 = dense_assemble.launches
        got = dense_assemble(*parts, rows=(r0, r1))
        assert dense_assemble.launches == n0 + 1
        assert got.shape == (2, r1 - r0, 16, 64)
        assert torch.equal(got.reshape(2, r1 - r0, n), whole[:, r0:r1]), (r0, r1)
        assert torch.equal(got, _dense_assemble_plain(*parts, False, (r0, r1))), (r0, r1)
        assert _same_bits(dense_assemble(*parts, rows=(r0, r1)), got)


def _two_card_rank(rank, world, device, out_dir):
    """One NCCL rank of test_two_card_nccl_sharded_sweep_and_dense_solve."""
    from biem_helmholtz_sphere_tpu_torch.parallel import make_mesh, sharded_solve, sharded_sweep

    f = dict(dtype=torch.float64, device=torch.device("cuda", torch.cuda.current_device()))
    ba = create_from_branching_types("ba")
    centers = torch.as_tensor(_lattice(), **f)
    x_dir = torch.tensor([1.0, 0.0, 0.0], **f)
    u = sharded_sweep(ba, centers=centers, radii=torch.ones(16, **f),
                      ks=torch.linspace(1.0, 1.5, 4, **f), n_end=8, direction=x_dir,
                      mesh=make_mesh(world, ("sweep",)))
    dens = sharded_solve(ba, centers=centers, radii=torch.ones(16, **f),
                         k=torch.tensor(1.3, **f), n_end=8, direction=x_dir,
                         mesh=make_mesh(world, ("rows",)))
    torch.save({"sweep": u.cpu(), "dense": dens.cpu(), "device": u.device.index},
               f"{out_dir}/rank{rank}.pt")


@pytest.mark.requires_cuda
def test_two_card_nccl_sharded_sweep_and_dense_solve(two_cards, tmp_path):
    """Two NCCL ranks, one on each card: the sharded sweep and the
    row-sharded dense solve equal on both ranks bit for bit, and within
    1e-10 of the single-card biem() (complex128)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.parallel._dryrun import spawn_ranks

    spawn_ranks(_two_card_rank, 2, str(tmp_path), "cuda", str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert [r["device"] for r in ranks] == [0, 1]
    for name in ("sweep", "dense"):
        assert _same_bits(ranks[0][name], ranks[1][name]), name
    dev = two_cards[0]
    f = dict(dtype=torch.float64, device=dev)
    ba = create_from_branching_types("ba")
    centers = torch.as_tensor(_lattice(), **f)
    x_dir = torch.tensor([1.0, 0.0, 0.0], **f)
    ks = torch.linspace(1.0, 1.5, 4, **f)
    uin, _ = plane_wave(k=ks, direction=x_dir[:, None].expand(3, 4))
    ref = biem(ba, centers=centers.expand(4, 16, 3), radii=torch.ones(4, 16, **f), k=ks,
               n_end=8, uin=uin).uscat(torch.zeros(3, 1, **f))[0]
    assert _rel(ranks[0]["sweep"], ref.cpu()) < 1e-10
    k = torch.tensor(1.3, **f)
    uin, _ = plane_wave(k=k, direction=x_dir)
    ref = biem(ba, centers=centers, radii=torch.ones(16, **f), k=k, n_end=8, uin=uin,
               solver="gmres").density
    assert _rel(ranks[0]["dense"], ref.cpu()) < 1e-8


# KE (the general evaluation) and K3 (the rotation D)
KE_TREES = [("a", 16), ("bpa", 12), ("bba", 8), ("bpbpa", 6), ("caa", 8), ("bcaa", 5),
            ("bbba", 5), ("cbaba", 3)]
KE_TOL = {torch.complex64: 3e-5, torch.complex128: 1e-12}
K3_TOL = {torch.complex64: 5e-5, torch.complex128: 1e-12}


def _ke_case(dev, dtype, btype, n_end, complex_k, seed=61, n_pts=300):
    """(tree, n_end, x [d, K, P], per-k centers [K, B, d], k [K], w
    [K, B, H], the mask of points outside every sphere [P, K]) with unit
    spheres and some points within 0.05 of a sphere."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(seed)
    c = create_from_branching_types(btype)
    d, n_k, n_b = c.c_ndim, 3, 4
    ell = basis(c, n_end).n_root
    centers = rng.normal(size=(n_k, n_b, d)) * 3.0
    x = rng.normal(size=(d, n_k, n_pts)) * 5.0
    # points just outside the first sphere of each k
    n_near = min(20, n_pts // 2)
    u = rng.normal(size=(d, n_k, n_near))
    x[:, :, :n_near] = centers[:, 0].T[:, :, None] + 1.05 * u / np.linalg.norm(u, axis=0)
    k = np.linspace(0.5, 3.0, n_k) + (0.1j if complex_k else 0.0)
    w = _randc(rng, (n_k, n_b, len(ell))) * np.exp(-0.3 * ell)
    f = dict(dtype=rdt, device=dev)
    xt, ct = torch.as_tensor(x, **f), torch.as_tensor(centers, **f)
    keep = (torch.linalg.vector_norm(xt[..., None] - ct.permute(2, 0, 1)[:, :, None], dim=0)
            > 1.0).all(-1).T
    return (c, n_end, xt, ct,
            torch.as_tensor(k, dtype=dtype if complex_k else rdt, device=dev),
            torch.as_tensor(w, dtype=dtype, device=dev), keep)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("btype,n_end", KE_TREES)
def test_harmonic_eval_against_its_plain_version(cuda, dtype, btype, n_end):
    """KE on every tree kind ('a', 'bpa', 'bba', 'bpbpa', 'caa', 'bcaa',
    'bbba': every node count's instance; 'cbaba', 5 nodes: the generic
    one), in both modes (301 and 300 points x 3 k, 301 no multiple of the
    points a thread or a CTA's; 4 and 3 points x 3 k), real and complex k,
    each k's own centers and points, summed and per ball, against its
    plain version within 3e-5 (complex64) / 1e-12 (complex128) of the
    largest |u|; a second launch is bitwise equal."""
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import (
        _harmonic_eval_plain, harmonic_eval)

    for complex_k, n_pts in ((False, 301), (True, 300), (False, 4), (True, 3)):
        c, n, x, cen, k, w, keep = _ke_case(cuda, dtype, btype, n_end, complex_k, n_pts=n_pts)
        for per_ball in (False, True):
            before = (harmonic_eval.launches, harmonic_eval.few_launches)
            got = harmonic_eval(c, n, x, cen, k, w, per_ball=per_ball)
            assert (harmonic_eval.launches, harmonic_eval.few_launches) == (
                before[0] + 1, before[1] + int(n_pts < 10))
            ref = _harmonic_eval_plain(c, n, x, cen, k, w, per_ball)
            assert got.shape == ref.shape
            assert bool(torch.isfinite(got[keep]).all())
            assert _rel(got[keep], ref[keep]) < KE_TOL[dtype], (complex_k, per_ball)
            again = harmonic_eval(c, n, x, cen, k, w, per_ball=per_ball)
            assert _same_bits(again, got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_harmonic_eval_at_the_bench_shape_repeats_over_ball_slices(cuda, dtype):
    """KE at chip_smoke's shape (i), 'bpa' at the bench (16 spheres, 4 x 4
    at pitch 4), n_end=32, 131,072 points: in complex64 the balls split
    into several slices over the card's waves (complex128 fills whole
    waves unsliced), a second launch bitwise equal, within KE_TOL of its
    plain version at the points a radius off every sphere."""
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import (
        _PT, _ball_slices, _blocks_per_sm, _harmonic_eval_plain, _many_point_layout,
        _sm_count, harmonic_eval)
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_program import shape_code

    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(77)
    c, n_end, n_p = create_from_branching_types("bpa"), 32, 1 << 17
    g = (np.arange(4) - 1.5) * 4.0
    centers = np.stack([*np.meshgrid(g, g), np.zeros((4, 4))], -1).reshape(16, 3)
    f = dict(dtype=rdt, device=cuda)
    cen = torch.as_tensor(centers, **f).expand(1, 16, 3)
    x = torch.as_tensor(rng.normal(size=(3, 1, n_p)) * 20.0, **f)
    k = torch.tensor([7.0], **f)
    ell = basis(c, n_end).n_root
    w = torch.as_tensor(_randc(rng, (1, 16, len(ell))) * np.exp(-ell), dtype=dtype, device=cuda)
    elt = torch.empty((), dtype=dtype).element_size()
    wwin, glob, threads = _many_point_layout(c, n_end, elt)
    slots = _blocks_per_sm(shape_code(c), 1, threads, n_end, wwin, glob,
                           int(dtype == torch.complex128)) * _sm_count(cuda)
    bpz = _ball_slices(-(-n_p // (threads * _PT[rdt])), 16, slots)
    assert bpz < 16 or dtype == torch.complex128  # several slices
    got = harmonic_eval(c, n_end, x, cen, k, w)
    assert _same_bits(harmonic_eval(c, n_end, x, cen, k, w), got)
    ref = _harmonic_eval_plain(c, n_end, x, cen, k, w, False)
    far = (torch.linalg.vector_norm(x[:, 0, :, None] - cen[0].T[:, None, :], dim=0)
           >= 2.0).all(-1)
    r = ref[far].abs()
    err = float(((got[far] - ref[far]).abs() / torch.clamp(r, min=float(r.median()))).max())
    assert err < KE_TOL[dtype], err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("btype,n_end,dtype,layout", [
    ("bba", 32, torch.complex128, (2048, False, 128)),
    ("bpa", 128, torch.complex128, (2048, True, 128)),
    ("bpa", 128, torch.complex64, (2048, True, 128)),
])
def test_harmonic_eval_at_large_n_end(cuda, btype, n_end, dtype, layout):
    """KE where the density and the radial tables do not fit in shared
    memory together (4D n_end=32 in complex128, 'bpa' n_end=128 in both
    dtypes): the density in windows, the radial tables in shared memory or
    in a device scratch as `layout` (wwin, glob, threads a CTA) says,
    against its plain version as above, real and complex k, summed and per
    ball."""
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import (
        _harmonic_eval_plain, _many_point_layout, harmonic_eval)

    elt = torch.empty((), dtype=dtype).element_size()
    c = create_from_branching_types(btype)
    assert _many_point_layout(c, n_end, elt) == layout
    for complex_k in (False, True):
        c, n, x, cen, k, w, keep = _ke_case(cuda, dtype, btype, n_end, complex_k, n_pts=600)
        for per_ball in (False, True):
            got = harmonic_eval(c, n, x, cen, k, w, per_ball=per_ball)
            ref = _harmonic_eval_plain(c, n, x, cen, k, w, per_ball)
            assert bool(torch.isfinite(got[keep]).all())
            assert _rel(got[keep], ref[keep]) < KE_TOL[dtype], (complex_k, per_ball)
            assert _same_bits(harmonic_eval(c, n, x, cen, k, w, per_ball=per_ball), got)


def _k3_dirs(dev, rdt, d, n_dir=40, seed=67):
    t = np.random.default_rng(seed).normal(size=(n_dir, d))
    t[0] = 0.0
    t[0, -1] = 1.0  # the root axis itself, and its opposite
    t[1] = -t[0]
    return torch.as_tensor(t / np.linalg.norm(t, axis=1, keepdims=True), dtype=rdt, device=dev)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("btype,n_end,n_dir", [("ba", 19, 40), ("bpa", 10, 40), ("bba", 12, 40),
                                               ("bcaa", 6, 40), ("ba", 64, 40), ("ba", 19, 37),
                                               ("ba", 19, 200), ("bba", 24, 40)])
def test_rotation_blocks_against_its_plain_version(cuda, dtype, btype, n_end, n_dir):
    """K3 per degree block against its plain version (5e-5 complex64,
    1e-12 complex128, of 1: D is unitary), exact zeros between the blocks
    of a group, the packed form equal to the groups' blocks, the unitarity
    error within twice the plain version's, and a second launch bitwise
    equal; up to 3D n_end=64 (every job of the tree would not fit in
    shared memory: its pieces hold only the rows they read), direction
    counts that are no multiple of what a strip stacks (37 and 200 at
    n_end=19, blocks of 1 to 37 rows), and 4D n_end=24, whose largest
    block (g = 576) spans 9 CTA shares of 64 rows, more than a thread
    block cluster holds."""
    from biem_helmholtz_sphere_tpu_torch.harmonics import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
        RotationD, _k3_plan, _rotation_blocks_plain, rotation_blocks)

    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    c = create_from_branching_types(btype)
    if n_end == 24:
        assert max(len(s) for s in _k3_plan(c, n_end, dtype == torch.complex128).shares) > 8
    dirs = _k3_dirs(cuda, rdt, c.c_ndim, n_dir=n_dir)
    before = rotation_blocks.launches
    groups, got = rotation_blocks(c, dirs, n_end)
    assert rotation_blocks.launches == before + 1
    _, ref = _rotation_blocks_plain(c, dirs, n_end)
    n_root = basis(c, n_end).n_root
    for (s, e), g, r in zip(groups, got, ref):
        nr = torch.as_tensor(n_root[s:e], device=cuda)
        same = nr[:, None] == nr[None, :]
        assert bool((g[:, ~same] == 0).all())
        err = float((g - r).abs().max())
        eye = torch.eye(e - s, dtype=dtype, device=cuda)
        uni_g = float((g @ g.mH - eye).abs().max())
        uni_r = float((r @ r.mH - eye).abs().max())
        assert err < K3_TOL[dtype], (s, e, err, uni_g, uni_r)
        assert uni_g <= 2 * uni_r, (s, e, err, uni_g, uni_r)
    _, again = rotation_blocks(c, dirs, n_end)
    assert all(_same_bits(a, b) for a, b in zip(again, got))
    rot = RotationD(c, dirs, n_end)
    sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    assert _same_bits(rot.packed.vals, pack(_dense_of(groups, rot.blocks), sizes).vals)


def _dense_of(groups, blocks):
    h = groups[-1][1]
    out = blocks[0].new_zeros(blocks[0].shape[:-2] + (h, h))
    for (s, e), b in zip(groups, blocks):
        out[..., s:e, s:e] = b
    return out


@pytest.mark.requires_cuda
def test_ke_and_k3_raise_on_a_broken_launch(cuda, monkeypatch):
    """Given CUDA tensors and a launch that fails, KE and K3 raise: no
    fallback to their plain versions."""
    from biem_helmholtz_sphere_tpu_torch.ops import harmonic_eval as ke_mod
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation

    launch = kernels.launch

    def broken(name, *args):
        if name in ("bhs_harmonic_eval", "bhs_rotation_blocks"):
            raise RuntimeError(f"{name}: CUDA error 1")
        return launch(name, *args)

    c, n, x, cen, k, w, _ = _ke_case(cuda, torch.complex64, "bpa", 6, False)
    dirs = _k3_dirs(cuda, torch.float32, 3, n_dir=4)
    monkeypatch.setattr(kernels, "launch", broken)
    with pytest.raises(RuntimeError, match="bhs_harmonic_eval"):
        ke_mod.harmonic_eval(c, n, x, cen, k, w)
    with pytest.raises(RuntimeError, match="bhs_rotation_blocks"):
        _rotation.rotation_blocks(c, dirs, n)


# K6's shapes: (K, n, m, dtype, the steps j held): (i) the bench block,
# (ii) phase 6 (a)'s complex128 offset table, (iii) the 4D first block,
# (iv) the 32 x 32 lattice, (v) one system at an odd n, (vi) the 2D
# lattice's cold rung (4,096 circles x 3 harmonics, basis 4,608; its
# steps take every reduction and tile mode: 100 a spread reduction with h
# kept local, 200 a resident tile with h from the scratch, 580 and 1,161
# a streamed tile), and the plan's rarer paths: (vii) slices past half
# the shared memory (x and s in a scratch), (viii) more systems than
# CTAs (rounds), (ix) a streamed tile of an odd n in complex64 (a copy a
# row and piece)
_K6_CASES = {
    "i-bench": (4, 16384, 48, torch.complex64, (0, 7, 47)),
    "ii-offset-table-c128": (4, 16384, 192, torch.complex128, (0, 31, 191)),
    "iii-4d": (4, 45920, 48, torch.complex64, (0, 47)),
    "iv-lattice": (1, 369664, 48, torch.complex64, (0, 47)),
    "v-odd-c64": (1, 1001, 12, torch.complex64, (0, 11)),
    "v-odd-c128": (1, 1001, 12, torch.complex128, (0, 11)),
    "vi-cold-rung": (1, 12288, 4608, torch.complex64, (0, 100, 200, 580, 1161)),
    "vii-spill-c128": (2, 262144, 12, torch.complex128, (0, 11)),
    "viii-rounds": (300, 64, 6, torch.complex64, (0, 5)),
    "ix-odd-streamed": (1, 300001, 24, torch.complex64, (0, 23)),
}
K6_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-13}


def _k6_operator(device, n_sys, n, dtype, seed=0):
    """(mv, diag, r): a Jacobi-preconditioned operator I + 0.85 S + 0.1 S^5
    (S the cyclic shift) scaled by a random diagonal, whose GMRES residual
    falls ~0.95 a step (so no step up to 191 is masked at target 0), and a
    random vector."""
    g = torch.Generator().manual_seed(seed)
    d = (torch.rand(n_sys, n, generator=g, dtype=torch.float64) + 1.0) * torch.exp(
        1j * torch.rand(n_sys, n, generator=g, dtype=torch.float64))
    d = d.to(dtype).to(device)
    r = torch.randn(n_sys, n, generator=g, dtype=torch.complex128).to(dtype).to(device)

    def mv(x):
        return d * (x + 0.85 * torch.roll(x, 1, -1) + 0.1 * torch.roll(x, 5, -1))

    return mv, d, r


def _clone_state(st):
    return type(st)(*[t.clone() if isinstance(t, torch.Tensor) else t for t in st])


def _state_tensors(st):
    return {name: t for name, t in st._asdict().items()
            if isinstance(t, torch.Tensor) and name not in ("cwork", "rwork")}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_K6_CASES))
def test_k6_step_matches_the_plain_step(cuda, case):
    """K6 (one Arnoldi step) against its plain version from the same state
    and matvec at steps j of a solve: V, R (the rotated column h), Q, g and
    resid within 1e-5 (complex64) / 1e-13 (complex128) of each tensor's
    largest entry, steps and the flag word equal; a second launch bit for
    bit; a masked launch (no system active, or a residual non-finite)
    changes no state tensor."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
        _arnoldi_step_plain, arnoldi_state, arnoldi_step)

    n_sys, n, m, dtype, js = _K6_CASES[case]
    rdt = kernels.REAL_OF[dtype]
    mv, d, r = _k6_operator(cuda, n_sys, n, dtype)
    target = torch.zeros(n_sys, dtype=rdt, device=cuda)
    tiny = float(torch.finfo(rdt).tiny) ** 0.5
    st = arnoldi_state(r, d, target, m)
    for j in range(max(js) + 1):
        w = mv(st.V[:, j])
        if j in js:
            got, again, ref = _clone_state(st), _clone_state(st), _clone_state(st)
            n0 = arnoldi_step.launches
            arnoldi_step(got, w, j, target, tiny)
            arnoldi_step(again, w, j, target, tiny)
            assert arnoldi_step.launches == n0 + 2
            _arnoldi_step_plain(ref, w, j, target, tiny)
            assert ref.flag.tolist() == [1, 0, j + 1], "the step ran masked"
            for name, t in _state_tensors(got).items():
                want = getattr(ref, name)
                if t.dtype in (torch.int32,):
                    assert torch.equal(t, want), (name, j)
                else:
                    assert _rel(t, want) <= K6_TOL[dtype], (name, j, _rel(t, want))
                assert _same_bits(t, getattr(again, name)), (name, j)
            for word in ([0, 0, j], [1, 1, j]):
                masked = _clone_state(st)
                masked.flag.copy_(torch.tensor(word, dtype=torch.int32))
                before = _clone_state(masked)
                arnoldi_step(masked, w, j, target, tiny)
                for name, t in _state_tensors(masked).items():
                    assert _same_bits(t, getattr(before, name)), (name, word)
        _arnoldi_step_plain(st, w, j, target, tiny)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k6_backsolve_matches_the_plain_version(cuda, dtype):
    """The back-substitution kernel against its plain version at every j_f
    of a 48-step (complex64) / 192-step (complex128) cycle's R and g."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
        _arnoldi_step_plain, _backsolve_plain, arnoldi_state, backsolve)

    m = 48 if dtype == torch.complex64 else 192
    rdt = kernels.REAL_OF[dtype]
    mv, d, r = _k6_operator(cuda, 3, 4097, dtype, seed=1)
    target = torch.zeros(3, dtype=rdt, device=cuda)
    tiny = float(torch.finfo(rdt).tiny) ** 0.5
    st = arnoldi_state(r, d, target, m)
    for j in range(m):
        _arnoldi_step_plain(st, mv(st.V[:, j]), j, target, tiny)
    for j_f in range(1, m + 1):
        flag = torch.tensor([0, 0, j_f], dtype=torch.int32, device=cuda)
        n0 = backsolve.launches
        y = backsolve(st.R, st.g, flag, tiny)
        assert backsolve.launches == n0 + 1
        ref = _backsolve_plain(st.R, st.g, flag, tiny)
        assert bool((y[:, j_f:] == 0).all())
        assert _rel(y, ref) <= K6_TOL[dtype], (j_f, _rel(y, ref))
        assert _same_bits(backsolve(st.R, st.g, flag, tiny), y)


@pytest.mark.requires_cuda
def test_k6_backsolve_at_the_cold_rung(cuda):
    """The back-substitution kernel against its plain version on the 2D
    cold rung's shape (K 1, n 12,288, basis 4,608, complex64) after its
    1,162 steps: j_f = 1,162 (and the whole basis, j_f = m, on the same R)."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
        _arnoldi_step_plain, _backsolve_plain, arnoldi_state, backsolve)

    m, j_f = 4608, 1162
    mv, d, r = _k6_operator(cuda, 1, 12288, torch.complex64, seed=3)
    target = torch.zeros(1, dtype=torch.float32, device=cuda)
    tiny = float(torch.finfo(torch.float32).tiny) ** 0.5
    st = arnoldi_state(r, d, target, m)
    for j in range(j_f):
        _arnoldi_step_plain(st, mv(st.V[:, j]), j, target, tiny)
    assert st.flag.tolist() == [1, 0, j_f]
    n0 = backsolve.launches
    y = backsolve(st.R, st.g, st.flag, tiny)
    assert backsolve.launches == n0 + 1
    ref = _backsolve_plain(st.R, st.g, st.flag, tiny)
    assert bool((y[:, j_f:] == 0).all())
    assert _rel(y, ref) <= K6_TOL[torch.complex64], _rel(y, ref)
    assert _same_bits(backsolve(st.R, st.g, st.flag, tiny), y)
    # every column of R past j_f is 0 below its (0) diagonal: y = 0 there too
    full = torch.tensor([0, 0, m], dtype=torch.int32, device=cuda)
    assert _same_bits(backsolve(st.R, st.g, full, tiny)[:, :j_f], y[:, :j_f])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_k6_solves_match_the_plain_solve(cuda, dtype, monkeypatch):
    """Whole restarted solves on the card (every step and back-substitution
    through K6, the plain versions never called) against the same solves
    on the CPU (the plain versions): relres <= tol, x within 10 tol, the
    iterations equal in complex128 and within 1 in complex64; cold and
    warm, K = 3 at an odd n."""
    from biem_helmholtz_sphere_tpu_torch.ops import gmres_step
    from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

    tol = 3e-5 if dtype == torch.complex64 else 1e-11
    mv, d, b = _k6_operator(cuda, 3, 4097, dtype, seed=2)
    cpu = torch.device("cpu")

    def mv_cpu(x):
        return mv(x.to(cuda)).to(cpu)

    def refuse(*args):
        raise AssertionError("a plain version ran on CUDA tensors")

    for x0 in (None, 0.5 * b / d):
        monkeypatch.setattr(gmres_step, "_arnoldi_step_plain", refuse)
        monkeypatch.setattr(gmres_step, "_backsolve_plain", refuse)
        n0, i0 = gmres_step.arnoldi_step.launches, gmres_solve_op.steps_issued
        x, relres, iters = gmres_solve_op(mv, d, b, restart=24, x0=x0)
        assert gmres_step.arnoldi_step.launches - n0 == gmres_solve_op.steps_issued - i0 > 0
        monkeypatch.undo()
        xc, relc, itc = gmres_solve_op(mv_cpu, d.cpu(), b.cpu(), restart=24,
                                       x0=None if x0 is None else x0.cpu())
        assert float(relres.max()) <= tol and float(relc.max()) <= tol
        assert _rel(x.cpu(), xc) <= 10 * tol
        slack = 0 if dtype == torch.complex128 else 1
        assert int((iters.cpu() - itc).abs().max()) <= slack, (iters, itc)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("route", ["factored", "dense-gmres", "offset-table", "lattice"])
def test_gmres_routes_make_no_host_sync(cuda, route, monkeypatch):
    """Every GMRES route's solve (its matvec, K6's steps and back-
    substitution, the reads of the flag word through a pinned buffer and
    an event) runs under torch.cuda.set_sync_debug_mode("error"): no
    operation in it waits on the card, and K6 launched."""
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import arnoldi_step

    tree, centers, n_end, kw = {
        "factored": ("ba", _lattice(), 8, dict(solver="matfree", stable=True)),
        "dense-gmres": ("ba", _lattice(), 8, dict(solver="gmres")),
        "offset-table": ("ba", _lattice(), 8, dict(solver="matfree", stable=False)),
        "lattice": ("a", _square_lattice(8, 2), 8, dict()),
    }[route]
    solve = _core.gmres_solve_op
    ran = []

    def guarded(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = solve(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran.append(out[2].max())
        return out

    monkeypatch.setattr(_core, "gmres_solve_op", guarded)
    for dtype in (torch.float32, torch.float64):
        n0 = arnoldi_step.launches
        _solve_nd(cuda, tree, dtype, centers, n_end, 1.0, **kw)
        assert arnoldi_step.launches > n0
    assert len(ran) == 2


@pytest.mark.requires_cuda
def test_k6_raises_on_a_broken_launch(cuda, monkeypatch):
    """Given CUDA tensors and a K6 launch that fails, the solve raises: no
    fallback to the plain step."""
    from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op

    launch = kernels.launch

    def broken(name, *args):
        if name == "bhs_arnoldi_step":
            raise RuntimeError(f"{name}: CUDA error 1")
        return launch(name, *args)

    mv, d, b = _k6_operator(cuda, 2, 999, torch.complex64)
    monkeypatch.setattr(kernels, "launch", broken)
    with pytest.raises(RuntimeError, match="bhs_arnoldi_step"):
        gmres_solve_op(mv, d, b)


# KR (ops/plane_rhs.py): (tree, n_end, centers, K, per-k inputs and both
# terms): the bench; the bench with complex k, a direction and centers per k;
# phase 9 (b)'s 4,096 circles; 3D n_end=64 (H = 4,096); the 4D hypercube at
# n_end=20; the 5D pair; 'caa' per k; 40 k x 130 spheres (the grid's ranges
# of spheres and of k)
_KR_CASES = {
    "bench": ("ba", 32, lambda: _lattice(), 4, False),
    "bench-per-k": ("ba", 32, lambda: _lattice(), 4, True),
    "circles-4096": ("a", 32, lambda: _lattice(64)[:, :2], 1, True),
    "ba-n64": ("ba", 64, lambda: _lattice(), 4, False),
    "bba-4d": ("bba", 20, lambda: np.array(list(np.ndindex(2, 2, 2, 2))) * 4.0 - 2.0, 4, True),
    "bbba-5d": ("bbba", 8, lambda: np.array([[0.0, 2, 0, 0, 0], [0.0, -2, 0, 0, 0]]), 4, False),
    "caa-per-k": ("caa", 14, lambda: np.array(list(np.ndindex(2, 2, 2, 2))) * 4.0 - 2.0, 4,
                  True),
    "split": ("ba", 8, lambda: np.random.default_rng(3).normal(size=(130, 3)) * 20, 40, True),
}


def _kr_args(dev, cdt, case):
    """KR's arguments as `_core._rhs_plane_wave` gives them for a case of
    _KR_CASES (K5's j and j' at k rho)."""
    tree, n_end, centers_of, n_k, per_k = _KR_CASES[case]
    c = create_from_branching_types(tree)
    d = c.c_ndim
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=dev)
    rng = np.random.default_rng(21)
    centers = torch.as_tensor(centers_of(), **f)
    n_b = centers.shape[0]
    k = torch.linspace(7.0, 7.06, n_k, **f)
    direction = torch.zeros((d, n_k), **f)
    direction[0] = 1.0
    alpha = torch.ones((1, 1), dtype=cdt, device=dev).expand(n_k, n_b)
    beta = torch.zeros((1, 1), dtype=cdt, device=dev).expand(n_k, n_b)
    if per_k:
        k = k.to(cdt) + 0.1j
        direction = torch.as_tensor(rng.normal(size=(d, n_k)), **f)
        centers = centers + torch.as_tensor(rng.normal(size=(n_k, n_b, d)) * 0.1, **f)
        alpha = torch.as_tensor(_randc(rng, (n_k, n_b)), dtype=cdt, device=dev)
        beta = torch.as_tensor(_randc(rng, (n_k, n_b)), dtype=cdt, device=dev)
    direction = direction / torch.linalg.vector_norm(direction, dim=0, keepdim=True)
    radii = torch.as_tensor(rng.uniform(0.5, 1.0, size=(n_k, n_b)), **f)
    j, jp, _, _ = special.spherical_jh_all(d, n_end, (k[:, None] * radii).to(cdt))
    return c, n_end, j, jp, k, direction, centers, alpha, beta, True, per_k


def _degree_rel(got, ref, n_root, held=0.0):
    """Max over (k, sphere, degree) blocks of the error over the block's
    largest |ref|, over the blocks whose largest |ref| is at least `held`."""
    h = len(n_root)
    d, r = ((x.abs().reshape(-1, h)) for x in (got - ref, ref))
    g = torch.as_tensor(n_root, dtype=torch.long, device=got.device).expand_as(d)
    n_l = int(n_root.max()) + 1
    dm = d.new_zeros(d.shape[0], n_l).scatter_reduce(1, g, d, "amax")
    rm = r.new_zeros(d.shape[0], n_l).scatter_reduce(1, g, r, "amax")
    return float((dm / rm.clamp_min(torch.finfo(rm.dtype).tiny))[rm >= held].max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_KR_CASES))
def test_plane_wave_rhs_kernel_matches_plain(cuda, dtype, case):
    """KR against its plain version per (k, sphere, degree) block (1e-5 in
    complex64, 1e-12 in complex128: j_n falls by orders of magnitude from
    degree to degree, so a gate relative to the largest entry would pass a
    spoiled high degree), two launches bit for bit, one launch counted, and,
    its program cached, no host sync."""
    from biem_helmholtz_sphere_tpu_torch.ops.plane_rhs import (
        plane_wave_rhs, plane_wave_rhs_plain)

    args = _kr_args(cuda, dtype, case)
    n0 = plane_wave_rhs.launches
    got = plane_wave_rhs(*args)
    assert plane_wave_rhs.launches == n0 + 1
    ref = plane_wave_rhs_plain(*args)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert _degree_rel(got, ref, basis(args[0], args[1]).n_root) <= (
        1e-5 if dtype == torch.complex64 else 1e-12)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = plane_wave_rhs(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _same_bits(again, got)


@pytest.mark.requires_cuda
def test_plane_wave_rhs_in_biem_matches_the_cpu(cuda):
    """The bench's RHS through `_core._rhs_dispatch` (K5 and KR on the card)
    against the same call on the CPU tensors (K5's and KR's plain
    versions), complex128, per degree block within 1e-12."""
    from biem_helmholtz_sphere_tpu_torch import plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core

    c = create_from_branching_types("ba")
    out = []
    for dev in (cuda, torch.device("cpu")):
        f = dict(dtype=torch.float64, device=dev)
        k = torch.linspace(7.0, 7.06, 4, **f)
        uin, grad = plane_wave(k=k, direction=torch.tensor([[1.0] * 4, [0.5] * 4, [0.0] * 4],
                                                           **f))
        ones = torch.ones((4, 16), dtype=torch.complex128, device=dev)
        out.append(_core._rhs_dispatch(c, 32, torch.as_tensor(_lattice(), **f),
                                       torch.ones(4, 16, **f), ones, 0.5 * ones, uin, grad,
                                       (4,)).cpu())
    assert _degree_rel(out[0], out[1], basis(c, 32).n_root) <= 1e-12


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", list(_KR_CASES))
def test_plane_wave_rhs_cold_warm_and_turned(cuda, dtype, case):
    """KR with its kept Y: a cold call (the table and launch packs dropped:
    every slice formed), a warm one (the same direction: every slice read
    from the table) and one after the direction turned (every slice formed
    again), to a generic direction and then to the last axis (the z axis in
    3D: the pole, x = 1, of the tree's polar angles), each within 1e-5 /
    1e-12 of the plain version per (k, sphere, degree) block; warm gives
    cold's bits, each turned call a cold call's bits at its direction."""
    from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs

    args = _kr_args(cuda, dtype, case)
    turned = list(args)
    turned[5] = args[5] * 0.8 + torch.roll(args[5], 1, dims=0) * 0.6  # another direction
    turned[5] = turned[5] / torch.linalg.vector_norm(turned[5], dim=0, keepdim=True)
    pole = list(args)
    pole[5] = torch.zeros_like(args[5])
    pole[5][-1] = 1.0
    n_root = basis(args[0], args[1]).n_root
    tol = 1e-5 if dtype == torch.complex64 else 1e-12

    def cold(a):
        plane_rhs.kr_table.cache_clear()
        plane_rhs._packs.clear()
        return plane_rhs.plane_wave_rhs(*a)

    first = cold(args)
    warm = plane_rhs.plane_wave_rhs(*args)
    after = plane_rhs.plane_wave_rhs(*turned)
    at_pole = plane_rhs.plane_wave_rhs(*pole)
    for out, a in ((first, args), (warm, args), (after, turned), (at_pole, pole)):
        assert bool(torch.isfinite(out).all())
        assert _degree_rel(out, plane_rhs.plane_wave_rhs_plain(*a), n_root) <= tol
    assert _same_bits(warm, first)
    assert _same_bits(cold(turned), after)
    assert _same_bits(cold(pole), at_pole)


# the (k, sphere, degree) blocks complex64 holds to 1e-5: largest |f| at
# least float32's smallest normal over its epsilon (at 'ba' n_end = 64 and
# k rho = 3.5 .. 7, j_n falls below it past n ~ 35 in both versions alike)
_F32_HELD = float(torch.finfo(torch.float32).tiny / torch.finfo(torch.float32).eps)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["bench", "ba-n64", "bba-4d"])
def test_plane_wave_rhs_complex64_at_the_pole_against_complex128(cuda, case):
    """At a direction on the last axis (the z axis in 3D, x = 1 in the
    polar recurrences) KR in complex64 and its plain version in complex64
    each within 1e-5 per (k, sphere, degree) block (those float32 holds:
    `_F32_HELD`) of the plain version in complex128 on the same inputs
    (complex64's, widened).  Both form Y in double, rounded once: the plain
    complex64 version reads 9.5e-8 at 'ba' n_end=64 on the CPU, where Y in
    float32 read 1.35e-5."""
    from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs

    def cast(args, cdt, rdt):
        return [a.to(cdt if a.is_complex() else rdt) if isinstance(a, torch.Tensor) else a
                for a in args]

    low = list(_kr_args(cuda, torch.complex64, case))
    low[5] = torch.zeros_like(low[5])
    low[5][-1] = 1.0
    ref = plane_rhs.plane_wave_rhs_plain(*cast(low, torch.complex128, torch.float64))
    n_root = basis(low[0], low[1]).n_root
    for out in (plane_rhs.plane_wave_rhs(*low), plane_rhs.plane_wave_rhs_plain(*low)):
        assert bool(torch.isfinite(out).all())
        assert _degree_rel(out.to(torch.complex128), ref, n_root, _F32_HELD) <= 1e-5


@pytest.mark.requires_cuda
def test_plane_wave_rhs_on_a_side_stream_has_the_same_bits(cuda):
    """KR keeps a table per stream: a call under a side stream (its own
    table, formed cold there) gives the default stream's bits, warm and
    cold, and the default stream's table goes on as before."""
    from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs

    args = _kr_args(cuda, torch.complex64, "bench")
    plane_rhs.kr_table.cache_clear()
    plane_rhs._packs.clear()
    ref = plane_rhs.plane_wave_rhs(*args)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [plane_rhs.plane_wave_rhs(*args) for _ in range(2)]
    torch.cuda.current_stream().wait_stream(side)
    for out in got:
        assert _same_bits(out, ref)
    assert _same_bits(plane_rhs.plane_wave_rhs(*args), ref)
