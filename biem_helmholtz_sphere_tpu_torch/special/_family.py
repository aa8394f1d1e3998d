"""d-dimensional spherical Bessel/Hankel functions for orders 0..n_end-1.

Convention (as in biem_helmholtz_sphere_tpu.special._family):

    j_n^{(d)}(z) = sqrt(pi/2) z^{-(d-2)/2} J_{n+(d-2)/2}(z)
    h_n^{(d)}(z) = sqrt(pi/2) z^{-(d-2)/2} H^{(1)}_{n+(d-2)/2}(z)

With d = base + 2m, j_n^{(d)}(z) = z^{-m} j_{n+m}^{(base)}(z): odd d takes
base 3 (closed trigonometric seeds), even d base 2 (the cylinder seeds
sqrt(pi/2) (J0, J1, H0, H1) of `_cyl.py`).

Order recurrence: f_{n-1} + f_{n+1} = c_n f_n with c_n = (2n + base - 2)/z.
h_n by upward recurrence; j_n upward where n <= |z| and by a normalized
downward (Miller) recurrence elsewhere.  The scaled variants carry every
value as mantissa * exp(exponent) so nothing overflows in float32.

K5: on CUDA tensors `spherical_jh_scaled`, `spherical_h_scaled` and
`spherical_jh_all` launch one kernel, `csrc/spherical_jh.cu` (a warp per
z: the three recurrences on three lanes, the per-order epilogue across
the warp); on CPU tensors they run the plain versions below (`_*_plain`),
whose loops over the order run eagerly and which are the kernel's oracle.
"""

from functools import lru_cache

import numpy as np
import torch
from scipy.special import gamma as _sp_gamma

from ..ops import kernels
from ._cyl import cyl_jh01, cyl_table

_MILLER_BUFFER = 36
_SQRT_PI_2 = float(np.sqrt(np.pi / 2.0))
# kernel modes (csrc/spherical_jh.cu)
_SCALED, _H_ONLY, _UNSCALED = 0, 1, 2


def _rescale_for(dtype):
    """Log-scaling threshold: must be representable in the real dtype."""
    return 1e150 if dtype in (torch.float64, torch.complex128) else 1e30


def _base_and_shift(d):
    """(base, m) with d = base + 2 m: base 2 for even d, 3 for odd d."""
    if d < 2:
        raise ValueError(f"dimension must be >= 2, got {d}")
    base = 2 if d % 2 == 0 else 3
    return base, (d - base) // 2


def _as_complex(z):
    return z if z.is_complex() else z.to(
        torch.complex128 if z.dtype == torch.float64 else torch.complex64
    )


def _seeds(base, z):
    """(j0, j1, h0, h1) of the base family at complex z."""
    if base == 2:  # float64 seeds, rounded to z's dtype (special/_cyl.py)
        return tuple(f * _SQRT_PI_2 for f in cyl_jh01(z))
    sin, cos = torch.sin(z), torch.cos(z)
    eiz = torch.exp(1j * z)
    # |z| < 1e-4: series for j0, j1 (the closed forms cancel); h keeps its
    # closed form down to z = 0, which callers substitute anyway
    small = z.abs() < 1e-4
    zs = torch.where(small, torch.ones_like(z), z)
    z2 = z * z
    j0 = torch.where(small, 1.0 - z2 / 6.0 * (1.0 - z2 / 20.0), sin / zs)
    j1 = torch.where(
        small, z / 3.0 * (1.0 - z2 / 10.0 * (1.0 - z2 / 28.0)), sin / (zs * zs) - cos / zs
    )
    zh = torch.where(z == 0, torch.ones_like(z), z)
    h0 = eiz * (-1j) / zh
    h1 = -eiz * (zh + 1j) / (zh * zh)
    return j0, j1, h0, h1


def _upward(base, n_top, f0, f1, z):
    """Upward recurrence f_{n+1} = c_n f_n - f_{n-1}: [..., n_top+1]."""
    out = [f0, f1][: n_top + 1]
    inv = 1.0 / z
    fm, fn = f0, f1
    for n in range(1, n_top):
        fp = fn * inv * (2.0 * n + base - 2.0) - fm
        out.append(fp)
        fm, fn = fn, fp
    return torch.stack(out, dim=-1)


def _miller_down(base, n_max, z):
    """Downward (Miller) recurrence, unnormalized, with log-scaling.

    Returns (a [..., n_max+1], sig [..., n_max+1]): f_n = a_n exp(sig_n).
    """
    n_start = n_max + _MILLER_BUFFER
    inv = 1.0 / z
    rescale = _rescale_for(z.dtype)
    log_rescale = float(np.log(rescale))
    fn1 = torch.zeros_like(z)
    fn = torch.ones_like(z)
    sig = torch.zeros_like(z.real)
    fs, sigs = [], []
    for n in range(n_start, 0, -1):
        fm = fn * inv * (2.0 * n + base - 2.0) - fn1
        too_big = fm.abs() > rescale
        scale = torch.ones_like(sig).masked_fill(too_big, 1.0 / rescale)
        fm = fm * scale
        fn = fn * scale
        sig = sig + too_big.to(sig.dtype) * log_rescale
        fn1, fn = fn, fm
        fs.append(fm)
        sigs.append(sig)
    fs = torch.stack(fs[::-1], dim=-1)[..., : n_max + 1]
    sigs = torch.stack(sigs[::-1], dim=-1)[..., : n_max + 1]
    return fs, sigs


def family_jh(base, n_max, z):
    """j_n, h_n of the base family for n = 0..n_max at complex z."""
    z = _as_complex(z)
    j0, j1, h0, h1 = _seeds(base, z)
    h = _upward(base, n_max, h0, h1, z)
    j_up = _upward(base, n_max, j0, j1, z)
    a, sig = _miller_down(base, n_max, z)
    # Normalize via the Wronskian j_1 h_0 - j_0 h_1 = i / z^{base-1}.
    w_target = 1j / z ** (base - 1)
    e10 = torch.exp(sig[..., 1] - sig[..., 0])
    denom = a[..., 1] * e10 * h0 - a[..., 0] * h1
    s = w_target / denom
    j_down = s[..., None] * a * torch.exp(sig - sig[..., :1])
    n_arr = torch.arange(n_max + 1, device=z.device, dtype=z.real.dtype)
    j = torch.where(n_arr <= z.abs()[..., None], j_up, j_down)
    return j, h


def _shift_deriv(base, m, f, z, inv_zm):
    """Derivative of z^{-m} f_{n+m} given the base-family table f [..., n_top+1]."""
    n_arr = torch.arange(f.shape[-1], device=z.device, dtype=z.real.dtype)
    fm1 = torch.cat([f[..., 1:2], f[..., :-1]], dim=-1)
    fp = fm1 - f * ((1.0 / z)[..., None] * (n_arr + base - 2.0))
    fp = torch.cat([-f[..., 1:2], fp[..., 1:]], dim=-1)
    if m == 0:
        return fp
    return inv_zm[..., None] * (fp - f * ((1.0 / z) * m)[..., None])


def _spherical_jh_all_plain(d, n_end, z):
    base, m = _base_and_shift(d)
    at_zero = z == 0
    zs = torch.where(at_zero, torch.ones_like(z), z)
    n_top = n_end + m
    jf, hf = family_jh(base, n_top, zs)
    inv_zm = zs ** (-m) if m > 0 else torch.ones_like(zs)
    jp_full = _shift_deriv(base, m, jf, zs, inv_zm)
    hp_full = _shift_deriv(base, m, hf, zs, inv_zm)
    j = inv_zm[..., None] * jf[..., m : m + n_end]
    h = inv_zm[..., None] * hf[..., m : m + n_end]
    jp = jp_full[..., m : m + n_end]
    hp = hp_full[..., m : m + n_end]
    # z = 0 limits: j_n(0) = c_d delta_{n0}, j_n'(0) = (c_d/d) delta_{n1}
    c_d = _c_d(d)
    n_arr = torch.arange(n_end, device=z.device)
    z0 = at_zero[..., None]
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    inf = torch.full((), complex(np.inf, np.inf), dtype=z.dtype, device=z.device)
    j = torch.where(z0, torch.where(n_arr == 0, zero + c_d, zero), j)
    jp = torch.where(z0, torch.where(n_arr == 1, zero + c_d / d, zero), jp)
    h = torch.where(z0, inf, h)
    hp = torch.where(z0, inf, hp)
    return j, jp, h, hp


def _upward_scaled(base, n_top, f0, f1, z):
    """Upward recurrence in mantissa-exponent form: (mant, e), f = mant exp(e).

    Rescales whenever |mant| exceeds the dtype's threshold, so h_n stays
    representable far beyond the float32 overflow point.
    """
    zero_e = torch.zeros_like(z.real)
    if n_top == 0:
        return f0[..., None], zero_e[..., None]
    inv = 1.0 / z
    rescale = _rescale_for(z.dtype)
    log_rescale = float(np.log(rescale))
    mant, es = [f0, f1], [zero_e, zero_e]
    fm, fn, e = f0, f1, zero_e
    for n in range(1, n_top):
        fp = fn * inv * (2.0 * n + base - 2.0) - fm
        big = fp.abs() > rescale
        scale = torch.ones_like(e).masked_fill(big, 1.0 / rescale)
        fp = fp * scale
        fn = fn * scale
        e = e + big.to(e.dtype) * log_rescale
        fm, fn = fn, fp
        mant.append(fp)
        es.append(e)
    return torch.stack(mant, dim=-1), torch.stack(es, dim=-1)


def _scaled_deriv(base, m, mant, e, z, inv_zm_log):
    """Derivative in mantissa-exponent form given a scaled order table.

    f'_n = f_{n-1} - ((n + base - 2)/z) f_n; each output order carries
    exponent max(e_{n-1}, e_n) so both terms fold in with factors <= 1.
    """
    n_arr = torch.arange(mant.shape[-1], device=z.device, dtype=z.real.dtype)
    fm1 = torch.cat([mant[..., 1:2], mant[..., :-1]], dim=-1)
    em1 = torch.cat([e[..., 1:2], e[..., :-1]], dim=-1)
    ep = torch.maximum(em1, e)
    t1 = fm1 * torch.exp(em1 - ep)
    t2 = (mant * torch.exp(e - ep)) * ((1.0 / z)[..., None] * (n_arr + base - 2.0))
    fp = t1 - t2
    fp = torch.cat([-mant[..., 1:2], fp[..., 1:]], dim=-1)
    ep = torch.cat([e[..., 1:2], ep[..., 1:]], dim=-1)
    if m == 0:
        return fp, ep
    t3 = mant * torch.exp(e - ep) * ((1.0 / z) * m)[..., None]
    return fp - t3, ep + inv_zm_log[..., None]


def _normalize(mant, e):
    """Renormalize to max(|re|, |im|) = 1 and let the exponent carry the rest."""
    a = torch.maximum(mant.real.abs(), mant.imag.abs())
    ln = torch.log(torch.where(a > 0, a, torch.ones_like(a)))
    return mant * torch.exp(-ln), e + ln


def _spherical_jh_scaled_plain(d, n_end, z):
    base, m = _base_and_shift(d)
    n_top = n_end + m
    j0, j1, h0, h1 = _seeds(base, z)
    hm, he = _upward_scaled(base, n_top, h0, h1, z)
    jm_up, je_up = _upward_scaled(base, n_top, j0, j1, z)

    a, sig = _miller_down(base, n_top, z)
    # Wronskian normalization (see family_jh); keep |s| in the exponent.
    w_target = 1j / z ** (base - 1)
    e10 = torch.exp(sig[..., 1] - sig[..., 0])
    denom = a[..., 1] * e10 * h0 - a[..., 0] * h1
    s = w_target / denom
    s_abs = s.abs()
    s_hat = s * torch.where(s_abs > 0, 1.0 / s_abs, torch.ones_like(s_abs))
    jm_down = s_hat[..., None] * a
    je_down = sig - sig[..., :1] + torch.log(
        torch.where(s_abs > 0, s_abs, torch.ones_like(s_abs))
    )[..., None]

    n_arr = torch.arange(n_top + 1, device=z.device, dtype=z.real.dtype)
    use_up = n_arr <= z.abs()[..., None]
    jm = torch.where(use_up, jm_up, jm_down)
    je = torch.where(use_up, je_up, je_down)

    if m > 0:
        inv_zm_log = -m * torch.log(z.abs())
        zm_phase = (z / z.abs()) ** (-m)
    else:
        inv_zm_log = torch.zeros_like(z.real)
        zm_phase = torch.ones_like(z)

    jpm, jpe = _scaled_deriv(base, m, jm, je, z, inv_zm_log)
    hpm, hpe = _scaled_deriv(base, m, hm, he, z, inv_zm_log)

    def shift(mant, e):
        return (
            zm_phase[..., None] * mant[..., m : m + n_end],
            e[..., m : m + n_end] + inv_zm_log[..., None],
        )

    jm, je = shift(jm, je)
    hm, he = shift(hm, he)
    jpm = zm_phase[..., None] * jpm
    hpm = zm_phase[..., None] * hpm
    return (
        _normalize(jm, je),
        _normalize(jpm[..., m : m + n_end], jpe[..., m : m + n_end]),
        _normalize(hm, he),
        _normalize(hpm[..., m : m + n_end], hpe[..., m : m + n_end]),
    )


def _spherical_h_scaled_plain(d, n_end, z):
    base, m = _base_and_shift(d)
    _, _, h0, h1 = _seeds(base, z)
    hm, he = _upward_scaled(base, n_end + m, h0, h1, z)
    out_m = hm[..., m : m + n_end]
    out_e = he[..., m : m + n_end]
    if m > 0:
        out_e = out_e - m * torch.log(z.abs())[..., None]
        out_m = ((z / z.abs()) ** (-m))[..., None] * out_m
    return _normalize(out_m, out_e)


def _c_d(d):
    """j_n^{(d)}(0) = c_d delta_{n0}."""
    nu = 0.5 * (d - 2.0)
    return float(np.sqrt(np.pi / 2.0) * 2.0 ** (-nu) / _sp_gamma(nu + 1.0))


# per mode: (complex planes, exponent planes) of the kernel's output buffer
_PLANES = {_SCALED: (4, 4), _H_ONLY: (1, 1), _UNSCALED: (4, 0)}


@lru_cache(maxsize=None)
def _launch_consts(d, rdt):
    """(c_d, rescale, 1 / rescale, log(rescale)): the kernel's constants."""
    rescale = _rescale_for(rdt)
    return _c_d(d), rescale, 1.0 / rescale, float(np.log(rescale))


@lru_cache(maxsize=8)
def _cyl_coefs(device):
    """The cylinder seeds' coefficient table on a card (K5's base-2 mode)."""
    return torch.as_tensor(cyl_table(), device=device)


def spherical_jh(mode, d, n_end, z):
    """K5 wrapper: the kernel's outputs for complex z [...] in one mode.

    mode _SCALED: ((jm, je), (jpm, jpe), (hm, he), (hpm, hpe)); _H_ONLY:
    (hm, he); _UNSCALED: (j, jp, h, hp); each [..., n_end].  On CPU
    tensors this runs the plain version of the mode; on CUDA tensors it
    launches csrc/spherical_jh.cu or raises.  The kernel's outputs are
    views of one buffer.
    """
    base, m = _base_and_shift(d)
    z = _as_complex(z)
    if z.device.type == "cpu":
        plain = {_SCALED: _spherical_jh_scaled_plain, _H_ONLY: _spherical_h_scaled_plain,
                 _UNSCALED: _spherical_jh_all_plain}[mode]
        return plain(d, n_end, z)
    if z.device.type != "cuda":
        raise RuntimeError(f"spherical_jh: unsupported device {z.device}")
    if n_end < 1:
        raise ValueError(f"n_end must be >= 1, got {n_end}")
    if mode not in _PLANES:
        raise ValueError(f"unknown spherical_jh mode {mode}")
    n_c, n_r = _PLANES[mode]
    rdt = kernels.REAL_OF[z.dtype]
    zc = z.contiguous()
    n_z = zc.numel()
    plane = n_z * n_end
    # the complex planes, then the exponent planes two to a complex element
    buf = torch.empty(n_c * plane + (n_r * plane + 1) // 2, dtype=z.dtype, device=z.device)
    cyl = _cyl_coefs(z.device)
    kernels.launch("bhs_spherical_jh", zc, buf, n_z, n_end, base, m, mode, d, cyl,
                   cyl.numel(), *_launch_consts(d, rdt), int(rdt == torch.float64))
    spherical_jh.launches += 1
    shape = tuple(z.shape) + (n_end,)
    if mode == _UNSCALED:
        f = buf.view((4,) + shape)
        return f[0], f[1], f[2], f[3]
    if mode == _H_ONLY:
        return buf[:plane].view(shape), buf.view(rdt)[2 * plane : 3 * plane].view(shape)
    f = buf.view((6,) + shape)
    e = f[4:].view(rdt).view((4,) + shape)
    return (f[0], e[0]), (f[1], e[1]), (f[2], e[2]), (f[3], e[3])


spherical_jh.launches = 0


def spherical_jh_all(d, n_end, z):
    """j_n^{(d)}, j_n', h_n^{(d)}, h_n' for n = 0..n_end-1 at z.

    Returns (j, jp, h, hp), complex, each [..., n_end].
    """
    return spherical_jh(_UNSCALED, d, n_end, z)


def spherical_jh_scaled(d, n_end, z):
    """Scaled j, j', h, h' for n = 0..n_end-1: ((jm,je),(jpm,jpe),(hm,he),(hpm,hpe)).

    Each value is mant * exp(e) with |mant| ~ 1.  z must be nonzero.
    """
    return spherical_jh(_SCALED, d, n_end, z)


def spherical_h_scaled(d, n_end, z):
    """Scaled outgoing h_n only: (mant, e) with h_n = mant * exp(e).

    Upward recurrence only (no Miller pass); |mant| normalized to ~1.
    """
    return spherical_jh(_H_ONLY, d, n_end, z)


def _clamp_limit(dtype):
    """The largest exponent `_h_clamped` keeps (and KA's and KE's chains)."""
    return 700.0 if dtype in (torch.float64, torch.complex128) else 80.0


def _h_clamped(d, n_end, z):
    """Outgoing radial table h_n(z) with overflow-clamped magnitude.

    Where |h_n(kr)| overflows, the density has underflowed to 0, so the
    clamp only prevents 0 * inf = NaN in the harmonic sum.
    """
    hm, he = spherical_h_scaled(d, n_end, z)
    return hm * torch.exp(torch.clamp(he, max=_clamp_limit(he.dtype)))
