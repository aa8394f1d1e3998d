"""Addition-theorem translation operators (S|R) and (R|R).

With R_h(x) = j_{n_h}(k|x|) Y_h(x^) and S_h(x) = h_{n_h}(k|x|) Y_h(x^):

    S_h(y + t) = sum_{h'} (S|R)[h', h](t) R_{h'}(y)          (|y| < |t|)
    R_h(y + t) = sum_{h'} (R|R)[h', h](t) R_{h'}(y)

and from the plane-wave expansion e^{i k x.s^} = A_d sum_h i^{n_h}
j_{n_h}(k|x|) Y_h(x^) conj(Y_h(s^)), A_d = 2^{(d+1)/2} pi^{(d-1)/2}.

`translation_matrix` dispatches as the JAX package's does: in 2D Graf's
closed form (`_graf_2d`, the KG kernel of ops/graf.py in its zero-exponent
mode); method None or "rotation" on 'b'/'bp'-rooted trees in d >= 3 the
rotation + coaxial decomposition (_rotation.sr_rotation); otherwise in
d >= 3 the (R|R) by its bounded plane-wave kernel (one contraction) and
the (S|R) by the band scan (`_sr_banded`, the KS kernel of
ops/band_sr.py); "gumerov" on the 3D "ba"/"bpa" tree the rotation +
the Gumerov-Duraiswami recurrence ladders (_gumerov.sr_gumerov).
"""

from functools import lru_cache

import numpy as np
import torch
from scipy.special import gamma

from ..harmonics._index import basis
from ..ops.band_sr import BandTables, band_coefs, band_sr
from ..ops.graf import graf_fold


def _a_const(d):
    return 2.0 ** ((d + 1) / 2.0) * np.pi ** ((d - 1) / 2.0)


def _surface_area(d):
    return float(2.0 * np.pi ** (d / 2.0) / gamma(d / 2.0))


def ipow(n, dtype, device):
    """i**n, exactly, for an integer tensor or array n: complex tensor."""
    m = torch.as_tensor(n, device=device) % 4
    re = (m == 0).to(torch.int8) - (m == 2).to(torch.int8)
    im = (m == 1).to(torch.int8) - (m == 3).to(torch.int8)
    return torch.complex(re.double(), im.double()).to(dtype)


@lru_cache(maxsize=32)
def _a_node_m(c, n_end):
    """2D: the signed order m of each flat harmonic (numpy int64 [H])."""
    b = basis(c, n_end)
    nid = c.root.nid
    ms = np.array([p[0] for p in b.node_jobs[nid]], dtype=np.int64)
    return ms[b.node_job_index[nid]]


@lru_cache(maxsize=32)
def _a_node_m_on(c, n_end, device):
    """`_a_node_m` as an int32 tensor on device (KG's order vector)."""
    return torch.as_tensor(_a_node_m(c, n_end), dtype=torch.int32, device=device)


def _polar_offsets(c, t_sph, t_cart):
    """(|t|, theta) of 2D offsets given by their spherical mapping or by
    cartesian t_cart [2, ...]."""
    if t_sph is None:
        from ..coords import from_cartesian

        t_sph = from_cartesian(c, t_cart)
    return t_sph["r"], t_sph[c.root.nid]


def _graf_2d(c, t_sph, n_out, n_in, k, kind, t_cart=None):
    """Closed-form 2D translation by Graf's addition theorem: complex
    [..., H_out, H_in].

    M[m', m] = i^{|m'|-|m|+|m-m'|} C_{|m-m'|}(k|t|) e^{i(m-m') theta_t},
    C = H^{(1)} for (S|R), J for (R|R), from K5's unscaled d = 2 family
    (sqrt(pi/2) times C) and KG in its zero-exponent mode.
    """
    from ..special._family import spherical_jh_all

    r_t, theta = _polar_offsets(c, t_sph, t_cart)
    z = k * r_t
    batch = torch.broadcast_shapes(z.shape, theta.shape)
    dev = theta.device
    m_out, m_in = _a_node_m_on(c, n_out, dev), _a_node_m_on(c, n_in, dev)
    # |m - m'| < (n_in - 1) + (n_out - 1) + 1 orders
    jf, _, hf, _ = spherical_jh_all(2, n_in + n_out - 1, z.expand(batch).reshape(1, -1))
    table = graf_fold(hf if kind == "SR" else jf, theta.expand(batch).reshape(1, -1),
                      m_out, m_in)
    return table.reshape(batch + table.shape[-2:])


def _quad_tables(c, n_out, n_in, dtype, device):
    """The band scan's quadrature tables (BandTables) in real dtype on
    device (a bare "cuda" is the current card), cached per (tree, n_out,
    n_in, dtype, device): the tree's product rule exact to degree
    2 ((n_out - 1) + (n_in - 1)), the harmonics at its nodes evaluated in
    float64 on device and then cast (one table for the rows and the
    columns when n_out == n_in)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _quad_tables_on(c, n_out, n_in, dtype, device)


@lru_cache(maxsize=4)
def _quad_tables_on(c, n_out, n_in, dtype, device):
    from ..coords import to_cartesian
    from ..harmonics._eval import harmonics
    from ..harmonics._quad import sphere_quadrature

    sph, w = sphere_quadrature(c, 2 * ((n_out - 1) + (n_in - 1)))
    f64 = dict(dtype=torch.float64, device=device)
    sph_t = {key: torch.as_tensor(v, **f64) for key, v in sph.items()}
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    yo = harmonics(c, sph_t, n_out).to(cdt)
    yi = yo if n_in == n_out else harmonics(c, sph_t, n_in).to(cdt)
    return BandTables.build(
        torch.as_tensor(w, dtype=dtype, device=device),
        to_cartesian(c, sph_t, include_r=False).to(dtype), yo, yi,
        basis(c, n_out).n_root.astype(np.int32), basis(c, n_in).n_root.astype(np.int32))


def _unit_offsets(c, t_sph, t_cart):
    """(|t|, t^ [..., d]) of offsets by their cartesian t_cart [d, ...]
    (norm and divide) or their spherical mapping."""
    if t_cart is not None:
        t_vec = torch.movedim(t_cart, 0, -1)
        r_t = torch.linalg.vector_norm(t_vec, dim=-1)
        return r_t, t_vec / torch.where(r_t > 0, r_t, torch.ones_like(r_t))[..., None]
    from ..coords import to_cartesian

    r_t = t_sph["r"]
    return r_t, torch.movedim(to_cartesian(c, {**t_sph, "r": torch.ones_like(r_t)}), 0, -1)


def _band_inputs(c, t_sph, t_cart, n_out, n_in, k):
    """(z = k |t| flattened [1, P], t^ [1, P, d], tables, batch shape) of
    the band scan over the broadcast batch of the offsets and k."""
    r_t, t_hat = _unit_offsets(c, t_sph, t_cart)
    rdt = torch.promote_types(r_t.dtype, k.real.dtype)
    batch = torch.broadcast_shapes(r_t.shape, k.shape)
    z = (k * r_t.to(rdt)).expand(batch).reshape(1, -1)
    t_hat = t_hat.to(rdt).expand(batch + t_hat.shape[-1:]).reshape(1, -1, t_hat.shape[-1])
    return z, t_hat, _quad_tables(c, n_out, n_in, rdt, t_hat.device), batch


def _band_consts(d):
    """(Omega_d, A_d) of the zonal kernel and the plane-wave expansion."""
    return _surface_area(d), _a_const(d)


def _sr_banded(c, t_sph, t_cart, n_out, n_in, k, kind):
    """The (S|R) (or (R|R)) by the band scan in d >= 3: complex [..., H_out,
    H_in] over the broadcast batch of the offsets and k.  One K5 launch
    (h or j at k|t|) and one KS launch (ops/band_sr.py) on CUDA tensors."""
    from ..special._family import spherical_jh_all

    d = c.c_ndim
    z, t_hat, tab, batch = _band_inputs(c, t_sph, t_cart, n_out, n_in, k)
    jf, _, hf, _ = spherical_jh_all(d, tab.n_bands, z)
    coef = band_coefs(hf if kind == "SR" else jf, d, *_band_consts(d))
    out = band_sr(coef, t_hat, tab)
    return out.reshape(batch + out.shape[-2:])


def _rr_plane_wave(c, t_sph, t_cart, n_out, n_in, k):
    """The (R|R) by its bounded plane-wave kernel in d >= 3:
    i^{n'-n} sum_q e^{i k t.s_q} w_q conj(Y_{h'}(s_q)) Y_h(s_q), one
    contraction (`torch.matmul`) over the broadcast batch."""
    from ..coords import to_cartesian

    if t_cart is None:
        t_cart = to_cartesian(c, t_sph)
    rdt = torch.promote_types(t_cart.dtype, k.real.dtype)
    tab = _quad_tables(c, n_out, n_in, rdt, t_cart.device)
    ts = torch.matmul(torch.movedim(t_cart.to(rdt), 0, -1), tab.s_cart)  # [..., Q]
    f = torch.exp(1j * k[..., None] * ts) * tab.w
    m = torch.matmul((tab.yo.conj() * f[..., None]).mT, tab.yi)
    p_o = ipow(tab.n_o, m.dtype, m.device)
    return m * p_o[:, None] * ipow(tab.n_i, m.dtype, m.device).conj()[None, :]


_METHODS = (None, "triplet", "plane_wave", "gumerov", "rotation")


def check_method(kind, method):
    """The JAX package's validation of (kind, method): ValueError on an
    unknown method, on "plane_wave" with (S|R), and on an unknown kind."""
    if method not in _METHODS:
        raise ValueError(f"unknown translation method {method!r}")
    if kind == "SR" and method == "plane_wave":
        raise ValueError(
            'method="plane_wave" is only available for same-type (R|R) translation'
        )
    if kind not in ("SR", "RR"):
        raise ValueError(f"kind must be 'SR' or 'RR', got {kind!r}")


def translation_matrix(c, t, n_end, k, kind="SR", n_end_add=None, method=None):
    """Translation operator matrix, complex [..., H_out, H_in], for offsets t.

    t: cartesian offsets [d, ...] (tensor or array) or a spherical mapping
    (from_cartesian); k: real or complex wavenumber broadcastable to t's
    batch shape; kind "SR" (the BIEM inter-sphere coupling) or "RR";
    n_end_add: input degree cutoff (default n_end); method: None |
    "triplet" | "plane_wave" | "gumerov" | "rotation", as in the JAX
    package.  Convention:
    S_h(y + t) = sum_{h'} M[..., h', h] R_{h'}(y).  It runs on the device
    of t (or of k when t is not a tensor; on the card when neither is).
    """
    from ..ops.kernels import default_device
    from ._gumerov import _require_gumerov_tree, sr_gumerov
    from ._rotation import sr_rotation

    n_in = n_end if n_end_add is None else n_end_add
    check_method(kind, method)
    if isinstance(t, dict):
        t_sph, t_cart = t, None
        dev = next(iter(t.values())).device
    else:
        dev = t.device if isinstance(t, torch.Tensor) else (
            k.device if isinstance(k, torch.Tensor) else default_device())
        t_cart, t_sph = torch.as_tensor(t, device=dev), None
    k = torch.as_tensor(k, device=dev)
    if method == "gumerov":
        _require_gumerov_tree(c)
        if n_in != n_end:
            raise ValueError('method="gumerov" requires n_end_add == n_end')
        return sr_gumerov(c, t_sph, n_end, k, kind=kind, t_cart=t_cart)
    if c.c_ndim == 2:  # every other method is Graf's closed form in 2D
        return _graf_2d(c, t_sph, n_end, n_in, k, kind, t_cart=t_cart)
    use_rotation = method == "rotation" or (
        method is None and c.root.kind in ("b", "bp") and n_in == n_end
    )
    if use_rotation:
        return sr_rotation(c, t_sph, n_end, k, kind=kind, t_cart=t_cart)
    if kind == "RR":  # every method, as in the JAX package
        return _rr_plane_wave(c, t_sph, t_cart, n_end, n_in, k)
    return _sr_banded(c, t_sph, t_cart, n_end, n_in, k, kind)
