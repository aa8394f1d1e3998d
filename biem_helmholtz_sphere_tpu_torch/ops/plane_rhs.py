r"""KR: the plane-wave right-hand side.

From the plane-wave expansion e^{i k x.d^} = A_d sum_h i^{n_h}
j_{n_h}(k|x|) Y_h(x^) conj(Y_h(d^)), the boundary data of a plane wave on
sphere b, projected on conj(Y_h), is

    f_h(k, b) = -A_d i^{n_h} e^{i k d^.c_b} conj(Y_h(d^))
                (alpha_b j_{n_h}(k rho_b) + beta_b k j'_{n_h}(k rho_b))

(the JAX package's `biem/_core.py::_rhs_plane_wave`, which XLA fused on
the TPU), the alpha term where u_in was given, the beta term where its
gradient was.  `plane_wave_rhs` takes j and j' as K5 writes them
(`special/_family.py::spherical_jh_all` at k rho_b) and launches
`csrc/plane_rhs.cu` on CUDA tensors: Y_h at each k's direction from the
tree's program (`ops/harmonic_program.py`, its `hjob` and `n_root`),
evaluated once per slice of harmonics and direction and broadcast over the
spheres; on CPU tensors it runs `plane_wave_rhs_plain`, the same formula in
plain torch through `harmonics/_eval.py::harmonics`.
"""

from functools import lru_cache

import torch

from ..harmonics._index import basis
from ..translation._ops import _a_const, ipow
from . import kernels
from .harmonic_program import harmonic_program

_SLICE = 32  # harmonics per CTA (plane_rhs.cu kSlice)
# CTAs a launch aims at (two per SM of a 132-SM H100): fewer slices of
# harmonics than that split the spheres, then the k, over the grid, in
# ranges of at least _MIN_BALLS spheres and _MIN_K k (each range's CTAs
# evaluate their slice's Y again)
_FILL_CTAS = 2 * 132
_MIN_BALLS = 64
_MIN_K = 16


@lru_cache(maxsize=32)
def rhs_tables(c, n_end, dtype, device):
    """(n_idx [H] int64, cy_scale [H] complex: i^{n_h} (-A_d)) of the plain
    version on `device`, `dtype` the complex dtype; cached."""
    n_root = basis(c, n_end).n_root
    n_idx = torch.as_tensor(n_root, dtype=torch.long, device=device)
    return n_idx, ipow(n_idx, dtype, device) * (-_a_const(c.c_ndim))


def plane_wave_rhs_plain(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                         has_grad):
    """KR's plain version (and its CPU path): [K, B, H].

    j, jp [K, B, n_end] (complex), kw [K] real or complex, direction [d, K]
    (unit), centers [B, d] or [K, B, d], alpha / beta broadcastable to
    [K, B].  d^.c_b is summed over the axes in order, each product and sum
    rounded alone, as the kernel forms it."""
    from ..coords import from_cartesian
    from ..harmonics._eval import harmonics

    n_idx, cy_scale = rhs_tables(c, n_end, j.dtype, j.device)
    term = 0.0
    if has_uin:
        term = term + alpha[..., None] * j.index_select(-1, n_idx)
    if has_grad:
        term = term + beta[..., None] * (jp.index_select(-1, n_idx) * kw[:, None, None])
    y_dir = harmonics(c, from_cartesian(c, direction), n_end)  # [K, H]
    cy = y_dir.conj() * cy_scale
    centers = centers.expand(kw.shape[0], -1, -1) if centers.ndim == 2 else centers
    ip = direction[0][:, None] * centers[..., 0]
    for i in range(1, c.c_ndim):
        ip = ip + direction[i][:, None] * centers[..., i]
    phase = torch.exp(1j * kw[:, None] * ip)  # e^{i k d^.c_b}, complex k too
    return (phase[..., None] * term) * cy[:, None, :]


def _grid(h_num, n_balls, n_k):
    """(balls, k) a CTA takes: all of them unless the slices of harmonics
    leave the card idle (see _FILL_CTAS)."""
    slices = -(-h_num // _SLICE)
    n_b = min(-(-n_balls // _MIN_BALLS), max(1, -(-_FILL_CTAS // slices)))
    b_per = -(-n_balls // n_b)
    n_kr = min(-(-n_k // _MIN_K), max(1, -(-_FILL_CTAS // (slices * n_b))))
    return b_per, -(-n_k // n_kr)


def _kr_inputs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad):
    """(out shape, arguments) of a KR launch, checked: the arguments as
    csrc/plane_rhs.cu's entry takes them after `out`, by its order, with
    the program `pg` in place of its tables and the tensors in place of
    their addresses (strides in elements; a shared geometry, direction,
    k, alpha or beta has stride 0 along K)."""
    cdt = j.dtype
    if cdt not in kernels.REAL_OF:
        raise TypeError(f"plane_wave_rhs: dtype {cdt}")
    rdt = kernels.REAL_OF[cdt]
    d = c.c_ndim
    n_k, n_balls, ne = j.shape
    h_num = basis(c, n_end).num
    if (ne != n_end or jp.shape != j.shape or jp.dtype != cdt or not j.is_contiguous()
            or not jp.is_contiguous()):
        raise ValueError(f"plane_wave_rhs: j {tuple(j.shape)}, j' {tuple(jp.shape)} "
                         f"(contiguous [K, B, {n_end}] each)")
    if (direction.shape != (d, n_k) or centers.shape[-2:] != (n_balls, d)
            or centers.ndim not in (2, 3) or (centers.ndim == 3 and centers.shape[0] != n_k)
            or kw.shape != (n_k,)):
        raise ValueError(f"plane_wave_rhs: k {tuple(kw.shape)}, direction "
                         f"{tuple(direction.shape)}, centers {tuple(centers.shape)} for "
                         f"K={n_k}, B={n_balls}, d={d}")
    if direction.dtype != rdt or centers.dtype != rdt or kw.dtype not in (rdt, cdt):
        raise TypeError(f"plane_wave_rhs: k {kw.dtype}, direction {direction.dtype}, centers "
                        f"{centers.dtype} with {cdt}")
    alpha, beta = (t.expand(n_k, n_balls) for t in (alpha, beta))
    if alpha.dtype != cdt or beta.dtype != cdt:
        raise TypeError(f"plane_wave_rhs: alpha {alpha.dtype}, beta {beta.dtype} with {cdt}")
    cen = centers if centers.ndim == 3 else centers[None].expand(n_k, -1, -1)
    pg = harmonic_program(c, n_end, rdt, j.device)
    b_per, k_per = _grid(h_num, n_balls, n_k)
    return (n_k, n_balls, h_num), (
        j, jp, kw, kw.stride(0), int(kw.is_complex()), direction, direction.stride(0),
        direction.stride(1), cen, cen.stride(0), cen.stride(1), cen.stride(2), alpha,
        alpha.stride(0), alpha.stride(1), beta, beta.stride(0), beta.stride(1), pg, h_num, d,
        int(has_uin), int(has_grad), b_per, k_per, -_a_const(d))


def plane_wave_rhs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin, has_grad):
    """KR wrapper: the plane-wave right-hand side [K, B, H].  Arguments as
    `plane_wave_rhs_plain`.  On CPU tensors this runs the plain version; on
    CUDA tensors it launches csrc/plane_rhs.cu (one launch, counted in
    `plane_wave_rhs.launches`) or raises.  Once the tree's program is
    cached on the card it copies nothing from the host and waits on
    nothing."""
    if j.device.type == "cpu":
        return plane_wave_rhs_plain(c, n_end, j, jp, kw, direction, centers, alpha, beta,
                                    has_uin, has_grad)
    if j.device.type != "cuda":
        raise RuntimeError(f"plane_wave_rhs: unsupported device {j.device}")
    shape, args = _kr_inputs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                             has_grad)
    out = torch.empty(shape, dtype=j.dtype, device=j.device)
    pg = args[18]
    kernels.launch("bhs_plane_rhs", out, *args[:18], pg.n_root, pg.hjob, pg.nodes, pg.jobs,
                   pg.fam, pg.coef, pg.famr, pg.n_nodes, *shape, j.shape[2], *args[20:],
                   int(j.dtype == torch.complex128))
    plane_wave_rhs.launches += 1
    return out


plane_wave_rhs.launches = 0
