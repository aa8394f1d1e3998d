"""Parity of the port's rotation and scale-compensated coaxial factors with
the JAX package, on the CPU in float64, on the same numpy inputs.

Tolerance: both packages build D by the same quadrature and X by the same
grouped band sum in a different operation order; entries agree to 1e-12
of the largest entry (|D| ~ 1, |mant| ~ 1).
"""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._scaled import (
    coaxial_scaled as j_coaxial_scaled,
)
from biem_helmholtz_sphere_tpu_torch.biem._core import _radial_rows_scaled
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import pack
from biem_helmholtz_sphere_tpu_torch.translation import (
    coaxial_scaled,
    rotation_matrix,
)
from biem_helmholtz_sphere_tpu_torch.special import spherical_h_scaled
from biem_helmholtz_sphere_tpu_torch.translation._ops import ipow
from biem_helmholtz_sphere_tpu_torch.translation._rotation import RotationD, _coax_tables
from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
    _GROUP,
    _TILE,
    _UNIT_SLABS,
    _child_state_blocks,
    _coax_fold_packed_plain,
    _coax_packed,
    _coax_tiles,
    coax_fold,
    coax_fold_packed,
)


def _directions(rng, d, n):
    t = rng.normal(size=(n, d))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    # the Rodrigues edge cases: along, against and across the root axis
    e = np.zeros((3, d))
    e[0, -1], e[1, -1], e[2, 0] = 1.0, -1.0, 1.0
    return np.concatenate([t, e])


def test_rotation_matrix_is_exactly_degree_block_diagonal():
    """Off the degree blocks D is exactly zero (the mask that keeps f32
    error from reaching 0.23), so packing it into blocks is exact."""
    c = create_from_branching_types("ba")
    n_end = 10
    t_hat = _directions(np.random.default_rng(3), 3, 4)
    d = rotation_matrix(c, torch.as_tensor(t_hat), n_end)
    n_root = basis(c, n_end).n_root
    off = torch.as_tensor(n_root[:, None] != n_root[None, :])
    assert bool((d[:, off] == 0).all())


def test_coaxial_scaled_float32_past_overflow_is_finite():
    """At k t = 4 the plain float32 (S|R) overflows from n_end ~ 22; the
    scaled factor stays finite and matches float64 to float32 precision."""
    c = create_from_branching_types("ba")
    r, k = torch.tensor([4.0]), torch.tensor([[1.0]])
    m32, s32 = coaxial_scaled(c, r, 24, k)
    m64, s64 = coaxial_scaled(c, r.double(), 24, k.double())
    assert bool(torch.isfinite(m32).all()) and bool(torch.isfinite(s32).all())
    assert float(s64.max()) > 88.0  # beyond float32's exp range
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        m32.numpy(), m64.numpy(), rtol=0, atol=2e-5 * float(m64.abs().max())
    )


def _fold_exponents(c, n_end, ks, rdt=torch.float64):
    """Degree-level ball-max exponents (e_r, e_b) [K, L] of the radial rows
    of unit sound-soft spheres, as the factored operator folds them."""
    n_k = len(ks)
    f = dict(dtype=rdt)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    (_, _), (_, e_r), (_, e_b) = _radial_rows_scaled(
        c, n_end, torch.ones(n_k, 2, **f), torch.as_tensor(ks, **f), torch.ones(n_k, **f),
        torch.ones(n_k, 2, dtype=cdt), torch.zeros(n_k, 2, dtype=cdt),
    )
    starts = np.searchsorted(basis(c, n_end).n_root, np.arange(n_end))
    return tuple(e.amax(dim=-2)[:, starts].contiguous() for e in (e_r, e_b))


def _dense_fold(mant, s_mat, e_r, e_b, ell):
    """The fold of biem_helmholtz_sphere_tpu/biem/_core.py:557-584 on dense
    (mant, S) [K, NR, H, H] with degree-level e_r, e_b [K, L]."""
    starts = np.searchsorted(ell, np.arange(e_r.shape[-1]))
    s_small = s_mat[..., starts, :][..., starts]
    factor = np.exp(e_r[:, None, :, None] + s_small + e_b[:, None, None, :])
    return mant * factor[..., ell, :][..., ell]


def test_coax_fold_packed_plain_matches_jax_fold():
    """K2's plain version (the CPU path of coax_fold_packed) against the JAX
    package's coaxial_scaled + degree-level fold, at the packed entries."""
    c_t, c_j = create_from_branching_types("ba"), j_tree("ba")
    n_end = 8
    r = np.array([4.0, 4.0 * np.sqrt(2.0), 8.0])
    ks = np.array([1.3, 6.5])
    e_r, e_b = _fold_exponents(c_t, n_end, ks)
    m_j, s_j = j_coaxial_scaled(c_j, r, n_end, ks[:, None], kind="SR")
    ell = basis(c_t, n_end).n_root
    xf_j = _dense_fold(tonp(m_j), np.asarray(s_j), e_r.numpy(), e_b.numpy(), ell)
    n0 = coax_fold.launches
    x = coax_fold_packed(c_t, n_end, torch.as_tensor(r), torch.as_tensor(ks), e_r, e_b)
    assert coax_fold.launches == n0  # CPU tensors take the plain version
    ref = xf_j[..., x.rows.numpy(), x.cols.numpy()]
    assert x.vals.shape == ref.shape == (2, 3, int((x.sizes.long() ** 2).sum()))
    np.testing.assert_allclose(x.vals.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    # nothing of the dense fold lies off the packed blocks
    off = np.ones(xf_j.shape[-2:], bool)
    off[x.rows.numpy(), x.cols.numpy()] = False
    assert not np.any(xf_j[..., off])


def test_coaxial_mant_is_exactly_zero_off_the_child_state_blocks():
    """The equal-child-state mask is exact, so the packed layout of K2 drops
    nothing: off the child-state blocks the dense mant is exactly zero."""
    c = create_from_branching_types("ba")
    n_end = 8
    mant, _ = coaxial_scaled(c, torch.tensor([4.0, 8.0], dtype=torch.float64), n_end,
                             torch.tensor([[1.3], [6.5]], dtype=torch.float64))
    cs = _coax_tables(c, n_end)[5]
    off = torch.as_tensor(cs[:, None] != cs[None, :])
    assert int(off.sum()) > 0 and bool((mant[..., off] == 0).all())
    assert bool((mant[..., ~off] != 0).any())


@pytest.mark.parametrize("rdt", [torch.float64, torch.float32])
def test_coax_fold_packed_matches_the_dense_route_past_the_overflow_wall(rdt):
    """Two spheres at t = 4, k = 1, n_end = 24, where S = log|h_{l+l'}|
    passes float32's exp range: the packed K2 values equal the dense route
    (coaxial_scaled, fold, pack) in each dtype, and float32 stays within
    float32 precision of float64."""
    c = create_from_branching_types("ba")
    n_end = 24
    r, ks = torch.tensor([4.0], dtype=rdt), np.array([1.0])
    e_r, e_b = _fold_exponents(c, n_end, ks, rdt)
    x = coax_fold_packed(c, n_end, r, torch.as_tensor(ks, dtype=rdt), e_r, e_b)
    mant, s_mat = coaxial_scaled(c, r, n_end, torch.as_tensor(ks, dtype=rdt)[:, None])
    assert float(s_mat.max()) > 88.0
    ell = basis(c, n_end).n_root
    dense = _dense_fold(mant.numpy(), s_mat.numpy(), e_r.numpy(), e_b.numpy(), ell)
    ref = pack(torch.as_tensor(dense), *_child_state_blocks(c, n_end)).vals.numpy()
    assert np.isfinite(x.vals.numpy()).all()
    tol = 1e-12 if rdt == torch.float64 else 2e-6
    np.testing.assert_allclose(x.vals.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    if rdt == torch.float32:
        e_r64, e_b64 = _fold_exponents(c, n_end, ks)
        x64 = coax_fold_packed(c, n_end, r.double(), torch.as_tensor(ks), e_r64, e_b64)
        np.testing.assert_allclose(x.vals.numpy(), x64.vals.numpy(), rtol=0,
                                   atol=2e-5 * float(x64.vals.abs().max()))


def _tiles(tab):
    """(start, count, top, first slab) of every tile of the K2 work units."""
    for start, cnt, g, slab in tab.units.tolist():
        for t in range(0, cnt, _TILE):
            yield start + t, min(_TILE, cnt - t), g, slab + (t // _TILE) * (g + 1)


@pytest.mark.parametrize("n_end", [2, 5, 32, 40])
def test_coax_tiles_cover_every_packed_entry_once(n_end):
    """The K2 kernel's host-built tables: `order` lists every packed entry
    once, with its degrees l_row + 65536 l_col; the work units cut it into
    runs of one top group (l + l') // _GROUP, largest first, each of at
    most unit_slabs slabs and, up to n_end = 32, at most 132 units (the
    H100's SMs); each tile's slabs hold its bands 0 .. 8 (top + 1) - 1 at
    [group, half, entry, band], zero past its entries; and no entry has a
    nonzero band above its top group."""
    c = create_from_branching_types("ba")
    tab = _coax_packed(c, n_end, torch.float64, torch.device("cpu"))
    u, (order, l_pair) = tab.u.numpy(), tab.order.numpy().T
    nbp, nnz = u.shape
    assert np.array_equal(np.sort(order), np.arange(nnz))
    np.testing.assert_array_equal(l_pair, (tab.l_row + 65536 * tab.l_col).numpy()[order])
    lsum = (tab.l_row + tab.l_col).numpy()
    top = lsum // _GROUP
    rows = np.arange(nbp)[:, None]
    assert not np.any(u[rows >= _GROUP * (top[None, :] + 1)])
    units = tab.units.numpy()
    np.testing.assert_array_equal(units, _coax_tiles(lsum, 132)[1])  # the host planner's
    assert 1 <= len(units) <= (132 if n_end <= 32 else nnz)
    assert units[0, 0] == 0 and np.array_equal(units[1:, 0], np.cumsum(units[:-1, 1]))
    assert units[-1, 0] + units[-1, 1] == nnz and np.all(units[:, 1] >= 1)
    assert np.all(np.diff(units[:, 2]) <= 0)  # largest top group first
    slabs = -(-units[:, 1] // _TILE) * (units[:, 2] + 1)
    assert tab.unit_slabs == slabs.max() <= max(_UNIT_SLABS, nbp // _GROUP)
    assert units[0, 3] == 0 and np.array_equal(units[1:, 3], np.cumsum(slabs[:-1]))
    image = tab.u_tiles.numpy()
    assert image.shape == (slabs.sum(), 2, _TILE, 4)
    for start, cnt, g, slab in _tiles(tab):
        ent = order[start : start + cnt]
        assert np.all(top[ent] == g)
        blk = image[slab : slab + g + 1].transpose(0, 1, 3, 2).reshape((g + 1) * _GROUP, _TILE)
        np.testing.assert_array_equal(blk[:, :cnt], u[: (g + 1) * _GROUP, ent])
        assert not np.any(blk[:, cnt:])


def _coax_fold_tiled(radm, rade, e_r, e_b, tab):
    """csrc/coax_fold.cu's computation in torch: tile by tile of the work
    units from the tile image, groups 0 .. top only, each group's scale
    from the unit's values of l + l', the fold at the end, written through
    `order`."""
    n_k, n_rad, nb = radm.shape
    n_p, (nbp, nnz) = n_k * n_rad, tab.u.shape
    radm, rade = radm.reshape(n_p, nb), rade.reshape(n_p, nb)
    re = rade[:, torch.clamp(torch.arange(nbp), max=nb - 1)]
    sig = re.reshape(n_p, nbp // _GROUP, _GROUP).amax(-1)
    coef = torch.nn.functional.pad(tab.iazf * radm, (0, nbp - nb))
    coef = coef * torch.exp(re - sig.repeat_interleave(_GROUP, dim=1))
    k = torch.arange(n_p) // n_rad
    out = torch.full((n_p, nnz), float("nan"), dtype=radm.dtype)
    for start, cnt, top, slab in _tiles(tab):
        dst = tab.order[start : start + cnt, 0].long()
        la, lb = tab.l_row[dst].long(), tab.l_col[dst].long()
        s = la + lb - _GROUP * top
        assert bool(((s >= 0) & (s < _GROUP)).all())
        u = tab.u_tiles[slab : slab + top + 1].permute(0, 1, 3, 2).reshape(-1, _TILE)[:, :cnt]
        rl = re[:, _GROUP * top + s]
        acc = torch.zeros((n_p, cnt), dtype=radm.dtype)
        for g in range(top + 1):
            t = coef[:, g * _GROUP : (g + 1) * _GROUP] @ u[g * _GROUP : (g + 1) * _GROUP].to(
                radm.dtype)
            acc += t * torch.exp(torch.clamp(sig[:, g, None] - rl, max=80.0))
        mant = acc * ipow(la, radm.dtype, "cpu") * ipow(lb, radm.dtype, "cpu").conj()
        out[:, dst] = mant * torch.exp(e_r[k][:, la] + rl + e_b[k][:, lb])
    return out.reshape(n_k, n_rad, nnz)


@pytest.mark.parametrize("n_end,n_rad", [(2, 1), (5, 7), (24, 3), (40, 2)])
def test_coax_fold_tiled_order_matches_plain(n_end, n_rad):
    """The kernel's tiled order of work (groups above an entry's top group
    skipped, scales by tile) gives the plain K2 values in float64, at one
    band group (n_end = 2), ragged tiles (n_end = 5: 85 entries), past the
    float32 overflow wall (n_end = 24, k t = 4) and at ten band groups
    (n_end = 40)."""
    c = create_from_branching_types("ba")
    ks = np.array([1.0, 2.5, 6.5])
    r = torch.as_tensor(np.linspace(4.0, 11.0, n_rad))
    e_r, e_b = _fold_exponents(c, n_end, ks)
    radm, rade = spherical_h_scaled(3, 2 * n_end - 1, torch.as_tensor(ks)[:, None] * r)
    tab = _coax_packed(c, n_end, torch.float64, torch.device("cpu"))
    ref = _coax_fold_packed_plain(radm, rade, e_r, e_b, tab)
    got = _coax_fold_tiled(radm, rade, e_r, e_b, tab)
    assert bool(torch.isfinite(ref).all())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("btype,n_end", [("ba", 7), ("bba", 5), ("bpbpa", 4), ("bbba", 4)])
def test_rotation_d_packed_equals_pack_of_the_dense_d(btype, n_end):
    """RotationD.packed, taken straight from the degree groups with the
    tree's own degree-block sizes (harm_n_ndim(n, d): 2n+1 in 3D, (n+1)^2
    in 4D), equals `pack` of the dense D value for value, in d = 3, 4, 5."""
    rng = np.random.default_rng(11)
    c = create_from_branching_types(btype)
    d = c.c_ndim
    t_hat = torch.as_tensor(_directions(rng, d, 4))
    rot = RotationD(c, t_hat, n_end)
    sizes = [harm_n_ndim(n, d) for n in range(n_end)]
    got = rot.packed
    ref = pack(rotation_matrix(c, t_hat, n_end), sizes)
    assert got.block_sizes == ref.block_sizes == tuple(sizes)
    assert torch.equal(got.vals, ref.vals)
    for name in ("offs", "sizes", "voffs", "rows", "cols"):
        assert torch.equal(getattr(got, name), getattr(ref, name))
