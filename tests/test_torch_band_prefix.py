"""The band scan's prefix form against a literal masked scan, in float64 and
float32, on the CPU (split from test_torch_band_sr.py so the test workers
share them; tolerances as there)."""

import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_sr_plain, band_coefs
from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts, _quad_tables

from test_torch_band_sr import (  # noqa: F401 (fixtures)
    F64,
    _offsets,
    block_rel,
    masked_scan,
)


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
