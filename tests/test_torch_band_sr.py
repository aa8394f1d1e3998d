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

import re
from pathlib import Path
from types import SimpleNamespace

import _jax_golden
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu.translation._ops import _sr_banded as j_sr_banded
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
from biem_helmholtz_sphere_tpu_torch.ops.band_sr import (
    _F_BYTES,
    _KF_NODES,
    _KF_THREADS,
    _KF_WIDTH,
    _band_f_plain,
    _band_sr_plain,
    _gegenbauer,
    band_coefs,
    band_sr,
    col_span,
    kf_chunks,
    kf_nodes,
    offset_groups,
    row_plan,
    row_tiles,
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


def _masked_scan_case():
    """(offsets [4, 3], k [2, 1]) of test_band_sr_matches_the_jax_masked_scan."""
    return _offsets(np.random.default_rng(17), 4, 3), np.array([[1.1], [1.7]])


def _wide_scan_case():
    """(offsets [4, 1], k [1, 1], n_end) of
    test_band_sr_matches_the_jax_masked_scan_across_kf_chunks: n_end = 9,
    NB = 17 bands, one more than KF's chunk of 16."""
    return _offsets(np.random.default_rng(29), 4, 1), np.array([[1.3]]), 9


def jax_golden():
    """The JAX package's `_sr_banded` that
    test_band_sr_matches_the_jax_masked_scan ((R|R)) and
    test_band_sr_matches_the_jax_masked_scan_across_kf_chunks ((S|R)) read:
    its band scan compiles for minutes on the CPU."""
    t, k = _masked_scan_case()
    tw, kw, n_w = _wide_scan_case()
    caa = j_tree("caa")
    return {"caa RR": tonp(j_sr_banded(caa, j_from_cartesian(caa, jnp.asarray(t)), 4, 4,
                                       jnp.asarray(k), "RR")),
            "caa SR wide": tonp(j_sr_banded(caa, j_from_cartesian(caa, jnp.asarray(tw)), n_w,
                                            n_w, jnp.asarray(kw), "SR"))}


def test_band_sr_matches_the_jax_masked_scan():
    """`_sr_banded` ((R|R) here: its j bands; the (S|R) is held in
    tests/test_torch_ctrees.py) against the JAX package's `_sr_banded` on
    'caa' at n_end=4 for three offsets and two k (1e-12 per degree block;
    the JAX values committed: `jax_golden`)."""
    t, k = _masked_scan_case()
    ref = _jax_golden.load("test_torch_band_sr")["caa RR"]
    c = create_from_branching_types("caa")
    got = _sr_banded(c, None, torch.as_tensor(t), 4, 4, torch.as_tensor(k), "RR").numpy()
    assert got.shape == ref.shape == (2, 3, 30, 30)
    n_o = _quad_tables(c, 4, 4, torch.float64, "cpu").n_o_host
    assert block_rel(got, ref, n_o, n_o) < 1e-12


def test_band_sr_matches_the_jax_masked_scan_across_kf_chunks():
    """`_sr_banded` ((S|R)) against the JAX package's on 'caa' at n_end=9,
    where NB = 17 bands cross KF's chunk of 16 (`kf_chunks`),
    one offset and one k (1e-12 per degree block; the JAX values
    committed: `jax_golden`)."""
    t, k, n_end = _wide_scan_case()
    ref = _jax_golden.load("test_torch_band_sr")["caa SR wide"]
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, n_end, n_end, torch.float64, "cpu")
    assert tab.n_bands == 17 and len(kf_chunks(tab.n_bands, _KF_WIDTH)) == 2
    got = _sr_banded(c, None, torch.as_tensor(t), n_end, n_end, torch.as_tensor(k), "SR").numpy()
    assert got.shape == ref.shape == (1, 1, 285, 285)
    assert block_rel(got, ref, tab.n_o_host, tab.n_o_host) < 1e-12


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
    """The kernel's 16-row M-tiles (each of one degree) cover the rows
    once: 71 at 'caa' n_end=14, 1,136 padded rows for 1,015; its plan holds
    each M-tile once, in 40 slots of two consecutive tiles of one degree;
    its widest N range over 64 columns is 6 bands; the degree blocks of
    the plain version's products cover the harmonics."""
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, 14, 14, torch.float64, "cpu")
    n_o = tab.n_o_host
    assert len(n_o) == 1015 and tab.n_bands == 27 and tab.w.shape[0] == 43740
    tiles = np.asarray(row_tiles(n_o))
    assert tiles[0, 0] == 0 and tiles[-1, 1] == 1015 and (tiles[1:, 0] == tiles[:-1, 1]).all()
    assert ((tiles[:, 1] - tiles[:, 0]) <= 16).all() and (tiles[:, 1] > tiles[:, 0]).all()
    assert all(n_o[a] == n_o[b - 1] for a, b in tiles)
    assert len(tiles) == sum(-(-(n + 1) ** 2 // 16) for n in range(14)) == 71
    assert 16 * len(tiles) == 1136
    plan = tab.plan.numpy()
    assert plan.shape == (40, 2, 2) and plan.dtype == np.int32
    on = plan[..., 1] > plan[..., 0]
    assert on[:, 0].all() and (plan[:, 1, 0] == plan[:, 0, 1]).all()
    assert sorted(map(tuple, plan[on].tolist())) == sorted(map(tuple, tiles.tolist()))
    assert all(n_o[a] == n_o[slot[0, 0]] for slot in plan for a, b in slot if b > a)
    spans = [n_o[min(s + 64, len(n_o)) - 1] - n_o[s] for s in range(0, len(n_o), 64)]
    assert tab.w_max == col_span(n_o) == max(spans) + 1 == 6
    rows, cols = tab.blocks
    assert rows == cols and len(rows) == 14
    assert [b - a for _, a, b in rows] == [(n + 1) ** 2 for n in range(14)]
    assert abs(float(tab.w.sum()) - 2 * np.pi ** 2) < 1e-12  # |S^3|


@pytest.mark.parametrize("n_end", [1, 2, 3, 5, 10])
def test_row_plan_covers_small_and_ragged_blocks(n_end):
    """Every row of small trees (blocks of 1, 4, 9 rows below the 16-row
    M-tile; slots whose second tile is empty) lies in exactly one live
    M-tile of the plan; a slot's tiles are consecutive and of one degree;
    an empty tile is (end, end) inside the table."""
    c = create_from_branching_types("caa")
    n_o = basis(c, n_end).n_root.astype(np.int32)
    plan = row_plan(n_o)
    seen = np.zeros(len(n_o), dtype=int)
    for slot in plan:
        assert slot[0, 1] > slot[0, 0] and slot[1, 0] == slot[0, 1]
        live = [(a, b) for a, b in slot if b > a]
        assert len({int(n_o[a]) for a, _ in live}) == 1
        assert all(0 <= a == b <= len(n_o) for a, b in slot if b <= a)
        for a, b in live:
            assert b - a <= 16
            seen[a:b] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n_out,n_in,dtype", [(5, 5, torch.complex64), (3, 5, torch.complex128),
                                              (8, 8, torch.complex128)])
def test_band_tables_pad_columns_to_eight(n_out, n_in, dtype):
    """The cached tables' column count is padded to a multiple of 8 by
    zeros (the kernel's 16-byte copies); yo and yi are views of the
    unpadded width over the same storage, one table when n_out == n_in."""
    c = create_from_branching_types("caa")
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    tab = _quad_tables(c, n_out, n_in, rdt, "cpu")
    for y, y_pad in ((tab.yo, tab.yo_pad), (tab.yi, tab.yi_pad)):
        h = y.shape[1]
        assert y_pad.dtype == dtype and y_pad.is_contiguous()
        assert y_pad.shape == (tab.w.shape[0], -(-h // 8) * 8)
        assert y.data_ptr() == y_pad.data_ptr() and y.stride() == y_pad.stride()
        assert not bool(y_pad[:, h:].any())
    assert (tab.yo_pad is tab.yi_pad) == (tab.yo is tab.yi) == (n_out == n_in)
    assert tab.q_pad % 16 == 0 and 0 <= tab.q_pad - tab.w.shape[0] < 16


def test_offset_groups_bound_the_f_scratch(monkeypatch):
    """The groups of offsets cover 0 .. K NO once in order, differ in size
    by at most one, and each group's F [G, NB, q_pad] fits the budget; at
    phase 10 (a)'s 160 offsets x 43,744 nodes x 27 bands: 3 groups in
    complex64, 6 in complex128 (512 MiB each at most); one offset a group
    when one does not fit."""
    from biem_helmholtz_sphere_tpu_torch.ops import band_sr as ks

    for n_ko, q_pad, n_b, size, budget in ((160, 43744, 27, 8, _F_BYTES),
                                           (160, 43744, 27, 16, _F_BYTES),
                                           (7, 400, 9, 8, 3 * 400 * 9 * 8), (5, 64, 4, 16, 1),
                                           (1, 16, 2, 8, _F_BYTES)):
        monkeypatch.setattr(ks, "_F_BYTES", budget)
        groups = offset_groups(n_ko, q_pad, n_b, size)
        assert groups[0][0] == 0 and groups[-1][1] == n_ko
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(groups, groups[1:]))
        sizes = [b - a for a, b in groups]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert max(sizes) == 1 or max(sizes) * q_pad * n_b * size <= budget
        want = {8: 3, 16: 6}[size] if budget == _F_BYTES and n_ko == 160 else None
        assert want is None or len(groups) == want
    monkeypatch.setattr(ks, "_F_BYTES", 3 * 400 * 9 * 8)
    assert offset_groups(7, 400, 9, 8) == [(0, 2), (2, 4), (4, 7)]
    monkeypatch.setattr(ks, "_F_BYTES", 1)
    assert len(offset_groups(5, 64, 4, 16)) == 5


def test_band_f_plain_is_the_prefix_kernel():
    """KF's plain version: F_N(q) = w_q sum_{n <= N} coef[N, n] C_n(t^.s_q)
    for the flattened offsets ko0 .. ko1 - 1 (t^ at k stride 0 here), laid
    out [G, NB, q_pad], zero past Q, against the sum written out (float64,
    1e-13 of each band's largest |F|)."""
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, 4, 5, torch.float64, "cpu")
    d, n_b = 4, tab.n_bands
    rng = np.random.default_rng(21)
    t = rng.normal(size=(1, 3, d))
    t_hat = torch.as_tensor(t / np.linalg.norm(t, axis=-1, keepdims=True), **F64)
    coef = torch.as_tensor(rng.normal(size=(2, 3, n_b, n_b)) + 1j * rng.normal(size=(2, 3, n_b, n_b)))
    coef = torch.tril(coef)
    got = _band_f_plain(coef, t_hat, tab, 2, 5)
    n_q = tab.w.shape[0]
    assert got.shape == (3, n_b, tab.q_pad) and not bool(got[..., n_q:].any())
    for i, ko in enumerate(range(2, 5)):
        k, o = divmod(ko, 3)
        x = (t_hat[0, o] @ tab.s_cart).numpy()
        cz = _gegenbauer(torch.as_tensor(x), n_b - 1, 1.0).numpy()
        want = np.stack([(cz[:, :big + 1] * coef[k, o, big, :big + 1].numpy()).sum(-1)
                         for big in range(n_b)], -1) * tab.w.numpy()[:, None]
        scale = np.abs(want).max(axis=0)
        assert (np.abs(got[i, :, :n_q].numpy().T - want) / scale).max() < 1e-13


@pytest.mark.parametrize("width", [_KF_WIDTH, 5, 32])
def test_kf_chunks_store_every_band_once(width):
    """KF's chunks (its width of 16, and two others) at NB = 1 .. 130: each
    holds width bands inside 0 .. max(NB, width) - 1, the last one full
    once NB >= width; the stored ranges lie inside their chunk and cover 0
    .. NB - 1 once, in order."""
    for n_b in range(1, 131):
        chunks = kf_chunks(n_b, width)
        assert len(chunks) == -(-n_b // width)
        stored = []
        for n0, lo, hi in chunks:
            assert 0 <= n0 <= lo < hi <= n0 + width and n0 + width <= max(n_b, width)
            stored += range(lo, hi)
        assert stored == list(range(n_b))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kf_nodes_cover_the_padded_nodes_once(dtype):
    """KF's node tiles: every node 0 .. q_pad - 1 once over the grid of
    ceil(q_pad / 256) CTAs; complex64 a lane's two nodes adjacent from an
    even one (one 16-byte store), complex128 each of a warp's stores 32
    consecutive nodes."""
    for q_pad in (16, 48, 256, 272, 15888, 43744):
        nodes = kf_nodes(q_pad, dtype)
        assert nodes.shape == (-(-q_pad // 256), _KF_THREADS // 32, 32, _KF_NODES)
        assert np.array_equal(np.sort(nodes[nodes < q_pad]), np.arange(q_pad))
        if dtype == torch.complex64:
            assert (nodes[..., 0] % 2 == 0).all() and (nodes[..., 1] == nodes[..., 0] + 1).all()
        else:
            assert (np.diff(nodes, axis=2) == 1).all()


def test_kf_constants_match_the_kernel():
    """The plan's width, threads and nodes a thread are csrc/band_sr.cu's."""
    src = (Path(__file__).resolve().parent.parent / "biem_helmholtz_sphere_tpu_torch" / "csrc"
           / "band_sr.cu").read_text()
    for name, value in (("kFWidth", _KF_WIDTH), ("kFThreads", _KF_THREADS),
                        ("kFNodes", _KF_NODES)):
        assert int(re.search(name + r" = (\d+);", src).group(1)) == value, name


def _emulate_kf(coef, t_hat, tab, ko0, ko1, width):
    """KF's order of work written out in float64 numpy: per chunk
    (`kf_chunks`) the recurrence from C_0, each band's accumulator summing
    coef[N, n] C_n in ascending n (the rows below the chunk, then its
    triangle), F = w acc for the chunk's stored bands, zero past Q."""
    n_k, n_off, n_b, _ = coef.shape
    d = t_hat.shape[-1]
    cf = coef.reshape(n_k * n_off, n_b, n_b)[ko0:ko1].numpy()
    x = t_hat.expand(n_k, n_off, d).reshape(-1, d)[ko0:ko1].numpy() @ tab.s_cart.numpy()
    n_q, nu = x.shape[1], 0.5 * (d - 2.0)
    out = np.zeros((ko1 - ko0, n_b, tab.q_pad), dtype=complex)
    for n0, lo, hi in kf_chunks(n_b, width):
        acc = np.zeros((ko1 - ko0, width, n_q), dtype=complex)
        cm, cc = np.zeros_like(x), np.ones_like(x)
        for n in range(min(n0 + width, n_b)):
            for j in range(max(n - n0, 0), min(width, n_b - n0)):
                acc[:, j] += cf[:, n0 + j, n, None] * cc
            cm, cc = cc, (2.0 * (n + nu) * x * cc - (n + 2.0 * nu - 1.0) * cm) / (n + 1.0)
        out[:, lo:hi, :n_q] = acc[:, lo - n0:hi - n0] * tab.w.numpy()
    return out


@pytest.mark.parametrize("width", [_KF_WIDTH, 32])
def test_kf_emulation_matches_the_plain_version(width):
    """KF's chunked, ascending-n accumulation (`_emulate_kf`, float64) at NB
    = 70 bands, past two chunks of its width (16; and of 32), against KF's
    plain version: 1e-13 of each band's largest |F|, for offsets 1 .. 4 of
    6 at per-k directions, on 50 random unit nodes in 4D (q_pad 64)."""
    rng = np.random.default_rng(23)
    n_b, n_q, d = 70, 50, 4
    s = rng.normal(size=(d, n_q))
    tab = SimpleNamespace(w=torch.as_tensor(rng.random(n_q), **F64), q_pad=64,
                          s_cart=torch.as_tensor(s / np.linalg.norm(s, axis=0), **F64))
    t = rng.normal(size=(2, 3, d))
    t_hat = torch.as_tensor(t / np.linalg.norm(t, axis=-1, keepdims=True), **F64)
    coef = torch.tril(torch.as_tensor(rng.normal(size=(2, 3, n_b, n_b))
                                      + 1j * rng.normal(size=(2, 3, n_b, n_b))))
    assert len(kf_chunks(n_b, width)) >= 3
    ref = _band_f_plain(coef, t_hat, tab, 1, 5).numpy()
    got = _emulate_kf(coef, t_hat, tab, 1, 5, width)
    assert got.shape == ref.shape == (4, n_b, 64) and not ref[..., n_q:].any()
    scale = np.abs(ref).max(axis=2, keepdims=True)
    assert (np.abs(got - ref) / scale).max() < 1e-13


def _emulate_kernel(coef, t_hat, tab):
    """KS's plan written out in torch: per offset, slot and 64 columns,
    Y_in F at the slot degree + each column's degree (F staged from N =
    n_lo for at most w_max bands), and each live M-tile's product as the
    kernel forms it on the FP64 tensor cores, A' [16, 2Q] = (Re, Im) of the
    raw rows node by node times B' [2Q, 2C] whose entry (2q + p, 2c + s) is
    component p ^ s of (Y_in F)[q, c], negated when p = s = 1; then the
    i-power at the store."""
    n_k, n_off, n_b, _ = coef.shape
    n_q = tab.w.shape[0]
    f = _band_f_plain(coef, t_hat, tab, 0, n_k * n_off)[..., :n_q]  # [KNO, NB, Q]
    h_out, h_in = tab.yo.shape[1], tab.yi.shape[1]
    hip = tab.yi_pad.shape[1]
    yo = torch.nn.functional.pad(tab.yo_pad, (0, 32))  # rows read past Hop are zero
    n_o, n_i = tab.n_o_host, tab.n_i_host
    out = torch.full((n_k * n_off, h_out, h_in), complex("nan"), dtype=coef.dtype)
    p = torch.arange(2 * n_q) % 2
    for ko in range(n_k * n_off):
        for slot in tab.plan.numpy():
            deg = int(n_o[slot[0, 0]])
            for c0 in range(0, h_in, 64):
                cols = np.arange(c0, min(c0 + 64, hip))
                ncol = n_i[np.minimum(cols, h_in - 1)]
                n_lo = deg + int(ncol[0])
                assert deg + ncol.max() - n_lo < tab.w_max
                f_tile = f[ko, n_lo:n_lo + tab.w_max]  # the staged bands
                bs = tab.yi_pad[:, cols] * f_tile[torch.as_tensor(deg + ncol - n_lo)].T
                parts = torch.stack([bs.real, bs.imag], -1)  # [Q, C, s]
                b_real = torch.empty(2 * n_q, 2 * len(cols), dtype=parts.dtype)
                for s in (0, 1):
                    comp = parts[..., s].repeat_interleave(2, 0)  # row 2q + p: comp s
                    other = parts[..., 1 - s].repeat_interleave(2, 0)
                    # component p ^ s, negated when p = s = 1
                    pick = torch.where((p ^ s)[:, None] == 1, other if s == 0 else comp,
                                       comp if s == 0 else other)
                    sign = torch.where((p & s)[:, None] == 1, -1.0, 1.0)
                    b_real[:, s::2] = pick * sign
                for r0, r1 in slot:
                    if r1 <= r0:
                        continue
                    a = yo[:, r0:r0 + 16]  # [Q, 16]
                    a_real = torch.stack([a.real, a.imag], 1).reshape(n_q * 2, 16).T
                    c_real = a_real @ b_real  # [16, 2C]
                    val = torch.complex(c_real[:, 0::2], c_real[:, 1::2])[:r1 - r0]
                    keep = cols < h_in
                    out[ko, r0:r1, cols[keep]] = val[:, torch.as_tensor(keep)]
    units = torch.tensor([1, 1j, -1, -1j], dtype=coef.dtype)
    rot = units[(tab.n_o.long()[:, None] - tab.n_i.long()[None, :]) % 4]
    return (out * rot).reshape(n_k, n_off, h_out, h_in)


@pytest.mark.parametrize("n_out,n_in", [(5, 5), (3, 6)])
def test_kernel_plan_and_real_embedding_match_the_plain_version(n_out, n_in):
    """The kernel's slots, 64-column tiles, staged N range of F and the real
    embedding of the complex product (four real products per complex one,
    the conj of the rows in B''s signs), emulated in torch, give the plain
    version's table (float64, 1e-12 per degree block): every entry is
    written once, from the right F_N."""
    c = create_from_branching_types("caa")
    tab = _quad_tables(c, n_out, n_in, torch.float64, "cpu")
    rng = np.random.default_rng(8)
    t = rng.normal(size=(2, 2, 4))
    t_hat = torch.as_tensor(t / np.linalg.norm(t, axis=-1, keepdims=True), **F64)
    r = torch.as_tensor(3.0 + rng.random((2, 2)), **F64)
    hm, he = spherical_h_scaled(4, tab.n_bands, torch.tensor([[0.9], [1.3]], **F64) * r)
    coef = band_coefs(hm * torch.exp(he), 4, *_band_consts(4))
    got = _emulate_kernel(coef, t_hat, tab)
    ref = _band_sr_plain(coef, t_hat, tab)
    assert block_rel(got, ref, tab.n_o_host, tab.n_i_host) < 1e-12


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
