"""KS's plain version (ops/band_sr.py), the band-scan (S|R) of any tree in
d >= 3, against the JAX package's masked band scan and against a literal
masked scan written here, on the CPU.

The plain version contracts the prefix F_N of the band kernel over the
quadrature nodes, one product per pair of degree blocks, where the JAX
package sums whole [H, H] contractions band by band under the Gaunt mask
n'' <= n' + n.  Tolerances: float64 1e-12 of each degree block's largest
entry (the two sum the same terms in another order); float32 against the
float64 masked scan 1e-5 per degree block (the masked scan in float32
itself keeps ~2e-6 there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._ops import _sr_banded as j_sr_banded
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.band_sr import (
    _band_sr_plain,
    _gegenbauer,
    band_coefs,
    band_sr,
)
from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
from biem_helmholtz_sphere_tpu_torch.translation import sr_scaled, translation_matrix
from biem_helmholtz_sphere_tpu_torch.translation._ops import (
    _band_consts,
    _quad_tables,
    _sr_banded,
)

F64 = dict(dtype=torch.float64)


def block_rel(got, ref, n_o, n_i):
    """Largest error relative to the largest |ref| of each (leading index,
    row degree, column degree) block."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    err = 0.0
    for a in np.unique(n_o):
        for b in np.unique(n_i):
            g, r = got[..., n_o == a, :][..., n_i == b], ref[..., n_o == a, :][..., n_i == b]
            d = np.abs(g - r).max(axis=(-2, -1))
            m = np.maximum(np.abs(r).max(axis=(-2, -1)), np.finfo(float).tiny)
            err = max(err, float((d / m).max()))
    return err


def masked_scan(c, tab, t_hat, rad, he=None):
    """The JAX package's masked band scan, written out in torch: band n''
    of i^{n''} A_d rad_{n''} Z_{n''}(t^.s) w, contracted with conj(Y_out)
    and Y_in, accumulated into the entries with n' + n >= n'' (scaled:
    each band times exp(min(he[n''] - he[n' + n], 80))), then the
    i^{n' - n} phase."""
    d = c.c_ndim
    omega, a_d = _band_consts(d)
    x = torch.matmul(t_hat, tab.s_cart)
    cz = _gegenbauer(x, tab.n_bands - 1, 0.5 * (d - 2.0))
    nsum = tab.n_o.long()[:, None] + tab.n_i.long()[None, :]
    units = torch.tensor([1, 1j, -1, -1j], dtype=rad.dtype)
    m = 0
    for n in range(tab.n_bands):
        zfac = (2.0 * n + d - 2.0) / ((d - 2.0) * omega) * a_d
        band = units[n % 4] * zfac * rad[..., n, None] * cz[..., n] * tab.w
        t_mat = (tab.yo.conj() * band[..., None]).mT @ tab.yi
        if he is not None:
            t_mat = t_mat * torch.exp(torch.clamp(he[..., n, None, None] - he[..., nsum],
                                                  max=80.0))
        m = m + torch.where(nsum >= n, t_mat, 0.0)
    return m * units[(tab.n_o.long()[:, None] - tab.n_i.long()[None, :]) % 4]


def _offsets(rng, d, n_off, length=3.5):
    t = rng.normal(size=(d, n_off))
    return t * length / np.linalg.norm(t, axis=0)


@pytest.mark.parametrize("tree,n_out,n_in", [
    ("caa", 5, 5), ("caa", 4, 6), ("bcaa", 4, 4), ("cbaba", 3, 3), ("ba", 7, 7), ("bba", 4, 4),
])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_prefix_form_matches_the_masked_scan(tree, n_out, n_in, scaled):
    """The plain version's prefix contraction equals the masked band scan
    (float64, 1e-12 per degree block), unscaled and with per-band
    exponents."""
    c = create_from_branching_types(tree)
    d = c.c_ndim
    tab = _quad_tables(c, n_out, n_in, torch.float64, "cpu")
    t = torch.as_tensor(_offsets(np.random.default_rng(5), d, 3), **F64)
    r = t.norm(dim=0)
    t_hat = (t / r).T[None]
    k = torch.tensor([0.9, 1.4], **F64)
    hm, he = spherical_h_scaled(d, tab.n_bands, k[:, None] * r)
    omega, a_d = _band_consts(d)
    if scaled:
        got = _band_sr_plain(band_coefs(hm, d, omega, a_d, he=he), t_hat, tab)
        ref = masked_scan(c, tab, t_hat, hm, he)
    else:
        h = hm * torch.exp(he)
        got = _band_sr_plain(band_coefs(h, d, omega, a_d), t_hat, tab)
        ref = masked_scan(c, tab, t_hat, h)
    assert got.shape == ref.shape == (2, 3, tab.yo.shape[1], tab.yi.shape[1])
    assert block_rel(got, ref, tab.n_o_host, tab.n_i_host) < 1e-12


@pytest.mark.parametrize("tree,n_end", [("caa", 8), ("bcaa", 5)])
def test_prefix_form_in_float32_keeps_the_masked_scans_digits(tree, n_end):
    """In float32 the prefix form loses no digits against the masked scan:
    both are held to the float64 masked scan per degree block (the masked
    scan in float32 keeps ~2e-6 of each block; a sequential sum over all
    the nodes would lose ~1e-4 of the small blocks, hence the two-level
    sum)."""
    c = create_from_branching_types(tree)
    d = c.c_ndim
    t = _offsets(np.random.default_rng(9), d, 2, 4.0)
    out = {}
    for rdt in (torch.float64, torch.float32):
        tab = _quad_tables(c, n_end, n_end, rdt, "cpu")
        tt = torch.as_tensor(t, dtype=rdt)
        r = tt.norm(dim=0)
        t_hat = (tt / r).T[None]
        hm, he = spherical_h_scaled(d, tab.n_bands, torch.tensor([1.2], dtype=rdt)[:, None] * r)
        coef = band_coefs(hm, d, *_band_consts(d), he=he)
        out[rdt] = (_band_sr_plain(coef, t_hat, tab), masked_scan(c, tab, t_hat, hm, he))
    ref = out[torch.float64][1].numpy()
    n_o = tab.n_o_host
    prefix32, masked32 = (x.to(torch.complex128).numpy() for x in out[torch.float32])
    assert block_rel(out[torch.float64][0], ref, n_o, n_o) < 1e-12
    assert block_rel(masked32, ref, n_o, n_o) < 1e-5
    assert block_rel(prefix32, ref, n_o, n_o) < 1e-5


def test_band_sr_matches_the_jax_masked_scan():
    """`_sr_banded` ((R|R) here: its j bands; the (S|R) is held in
    tests/test_torch_ctrees.py) against the JAX package's `_sr_banded` on
    'caa' at n_end=4 for three offsets and two k (1e-12 per degree
    block)."""
    rng = np.random.default_rng(17)
    t = _offsets(rng, 4, 3)
    k = np.array([[1.1], [1.7]])
    ref = tonp(j_sr_banded(j_tree("caa"), j_from_cartesian(j_tree("caa"), jnp.asarray(t)),
                           4, 4, jnp.asarray(k), "RR"))
    c = create_from_branching_types("caa")
    got = _sr_banded(c, None, torch.as_tensor(t), 4, 4, torch.as_tensor(k), "RR").numpy()
    assert got.shape == ref.shape == (2, 3, 30, 30)
    n_o = _quad_tables(c, 4, 4, torch.float64, "cpu").n_o_host
    assert block_rel(got, ref, n_o, n_o) < 1e-12


def test_scaled_band_scan_matches_unscaled_caa():
    """The port's twin of the JAX package's
    test_stable_scaled_matches_unscaled_caa: mant exp(S) of the scaled band
    scan equals the unscaled (S|R) to 1e-12 of its largest entry, and S is
    he[n' + n]."""
    c = create_from_branching_types("caa")
    t = torch.tensor([[0.4, 3.9, -0.7, 1.2], [1.0, -3.0, 0.4, 0.2]], **F64).T
    k = torch.tensor(1.3, **F64)
    ref = translation_matrix(c, t, 6, k, kind="SR")
    mant, s_mat = sr_scaled(c, None, 6, k, t_cart=t)
    err = float((mant * torch.exp(s_mat) - ref).abs().max() / ref.abs().max())
    assert err < 1e-12, err
    tab = _quad_tables(c, 6, 6, torch.float64, "cpu")
    _, he = spherical_h_scaled(4, tab.n_bands, k * t.norm(dim=0)[None])
    nsum = tab.n_o.long()[:, None] + tab.n_i.long()[None, :]
    assert torch.equal(s_mat, he[0][:, nsum])


def test_band_coefs_mask_and_clamp():
    """coef[N, n] is the band coefficient for n <= N and 0 above; with
    exponents it carries exp(min(he_n - he_N, 80)), the JAX package's
    clamp."""
    d = 4
    omega, a_d = _band_consts(d)
    rad = torch.tensor([[1.0 + 2.0j, -0.5j, 3.0, 0.25 + 0.0j]], dtype=torch.complex128)
    he = torch.tensor([[0.0, 100.0, 2.0, 5.0]], **F64)
    plain = band_coefs(rad, d, omega, a_d)[0]
    scaled = band_coefs(rad, d, omega, a_d, he=he)[0]
    for big_n in range(4):
        for n in range(4):
            if n > big_n:
                assert plain[big_n, n] == 0 and scaled[big_n, n] == 0
                continue
            c_n = 1j ** n * (2 * n + d - 2) / ((d - 2) * omega) * a_d * complex(rad[0, n])
            assert abs(complex(plain[big_n, n]) - c_n) < 1e-13 * abs(c_n)
            want = c_n * np.exp(min(float(he[0, n] - he[0, big_n]), 80.0))
            assert abs(complex(scaled[big_n, n]) - want) <= 1e-13 * abs(want)


def test_band_tables_tiles_and_blocks():
    """The kernel's row tiles (at most 32 rows, each of one degree) cover
    the rows once; its widest N range over 128 columns; the degree blocks
    of the plain version's products cover the harmonics."""
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, 14, 14, torch.float64, "cpu")
    n_o = tab.n_o_host
    assert len(n_o) == 1015 and tab.n_bands == 27 and tab.w.shape[0] == 43740
    tiles = tab.row_tiles.numpy()
    assert tiles[0, 0] == 0 and tiles[-1, 1] == 1015 and (tiles[1:, 0] == tiles[:-1, 1]).all()
    assert ((tiles[:, 1] - tiles[:, 0]) <= 32).all()
    assert all(n_o[a] == n_o[b - 1] for a, b in tiles)
    assert len(tiles) == sum(-(-(n + 1) ** 2 // 32) for n in range(14)) == 40
    spans = [n_o[min(s + 128, len(n_o)) - 1] - n_o[s] for s in range(0, len(n_o), 128)]
    assert tab.w_max == max(spans) + 1 == 7
    rows, cols = tab.blocks
    assert rows == cols and len(rows) == 14
    assert [b - a for _, a, b in rows] == [(n + 1) ** 2 for n in range(14)]
    assert abs(float(tab.w.sum()) - 2 * np.pi ** 2) < 1e-12  # |S^3|


@pytest.mark.parametrize("n_out,n_in", [(5, 5), (3, 5)])
def test_band_tables_hold_y_unconjugated_once(n_out, n_in):
    """The cached tables hold Y_out and Y_in as the harmonics at the nodes
    (the rows are conjugated where they are read), one tensor for both
    when n_out == n_in."""
    from biem_helmholtz_sphere_tpu_torch.coords import to_cartesian
    from biem_helmholtz_sphere_tpu_torch.harmonics._eval import harmonics
    from biem_helmholtz_sphere_tpu_torch.harmonics._quad import sphere_quadrature

    c = create_from_branching_types("caa")
    tab = _quad_tables(c, n_out, n_in, torch.float64, "cpu")
    assert (tab.yo is tab.yi) == (n_out == n_in)
    sph, w = sphere_quadrature(c, 2 * ((n_out - 1) + (n_in - 1)))
    sph_t = {key: torch.as_tensor(v, **F64) for key, v in sph.items()}
    assert torch.equal(tab.yo, harmonics(c, sph_t, n_out))
    assert torch.equal(tab.yi, harmonics(c, sph_t, n_in))
    assert torch.equal(tab.s_cart, to_cartesian(c, sph_t, include_r=False))
    gram = (tab.yo.conj() * tab.w[:, None]).mT @ tab.yi
    eye = torch.eye(*gram.shape, dtype=gram.dtype)
    assert float((gram - eye).abs().max()) < 1e-12


def test_band_sr_checks_its_arguments():
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, 3, 3, torch.float64, "cpu")
    coef = torch.zeros(1, 2, tab.n_bands, tab.n_bands, dtype=torch.complex128)
    t_hat = torch.zeros(1, 2, 4, **F64)
    assert band_sr(coef, t_hat, tab).shape == (1, 2, 14, 14)
    with pytest.raises(ValueError, match="do not match"):
        band_sr(coef[..., :-1, :-1], t_hat, tab)
    with pytest.raises(ValueError, match="do not match"):
        band_sr(coef, t_hat[..., :3], tab)
    with pytest.raises(ValueError, match="do not match"):
        band_sr(coef, t_hat, tab, he=torch.zeros(1, 2, tab.n_bands, **F64))
    with pytest.raises(RuntimeError, match="unsupported device"):
        band_sr(coef.to("meta"), t_hat.to("meta"), tab)


def test_sr_banded_takes_the_batch_of_offsets_and_k():
    """The band scan over k [K, 1] against offsets [d, NO] equals each k
    alone (float64, 1e-13 per degree block)."""
    c = create_from_branching_types("caa")
    t = torch.as_tensor(_offsets(np.random.default_rng(3), 4, 2))
    k = torch.tensor([[0.7], [1.9]], **F64)
    both = _sr_banded(c, None, t, 4, 4, k, "SR")
    n_o = _quad_tables(c, 4, 4, torch.float64, "cpu").n_o_host
    for i in range(2):
        alone = _sr_banded(c, None, t, 4, 4, k[i, 0], "SR")
        assert block_rel(both[i], alone, n_o, n_o) < 1e-13
