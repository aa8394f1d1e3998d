r"""BIEM assembly and solve: the dense and the matrix-free routes.

Combined-field indirect formulation: the unknown density on each sphere
is expanded in hyperspherical harmonics; on-sphere traces are diagonal per
harmonic (_layer.py) and inter-sphere coupling is the (S|R) translation
operator.  The system

  A[b,h;b',h'] = blc_{n'}(rho_b') * ( b == b' :
        delta_{hh'} (alpha_b h_n(k rho_b) + beta_b k h_n'(k rho_b))
      : (S|R)[h,h'](c_b - c_b') (alpha_b j_n(k rho_b) + beta_b k j_n'(k rho_b)) )

is solved by one of the routes of biem_helmholtz_sphere_tpu's `biem()`,
chosen by the same policy (`_route`):

* one sphere: the system is diagonal;
* dense (LU, or GMRES on the pair-major matrix): `_assemble` builds (S|R)
  once per distinct offset (translation/: rotation D, coaxial factor X by
  the K5 and K2 kernels, D X D^H by degree groups) and the KD kernel
  (ops/dense.py) gathers it into the dense matrix with the radial factors
  and the mirror parity;
* factored matrix-free (scale-compensated): SR(t) = D(t^) X(|t|) D(t^)^H
  is never formed.  D is cached per geometry; X is folded with the
  ball-maximum radial exponents and packed into its child-state blocks
  (K5 + K2).  One matvec routes the spheres into the compacted pair lanes
  (KC), applies D^H, X and D (KB) and sums the lanes back (KC); GMRES
  (ops/gmres.py) solves the system;
* offset-table matrix-free (unscaled, or with an `sr_map`): the dense
  route's per-offset (S|R) table [K, NO, H, H] is built once per k-block
  and one matvec applies it to the offset-sorted lanes (KC) in one
  batched product.

* lattice FFT (`_lattice.py`, 64 or more spheres on a square lattice or a
  line): the coupling is a block convolution over the cells, applied by
  FFTs of the per-offset table's kernel and one product per frequency.

The right-hand side is the closed form of a `plane_wave`, or the
quadrature projection of any other incident field (`_rhs_expansion`).
k may be complex.  Geometry that varies along the batch is never
matrix-free (as in the JAX package): the dense routes build each k's own
offset table and KD gathers it with that k's pair map.  2D trees ('a')
take every route, their (S|R) table Graf's closed form (KG, ops/graf.py;
never the factored operator); every dimension d >= 3 takes the same
routes for a tree rooted at a 'b' or 'bp' node.  A tree rooted at a 'c'
node takes every route but the factored operator, its (S|R) table the
band scan (KS, ops/band_sr.py).
"""

import warnings
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Literal

import numpy as np
import torch

from ..harmonics._index import basis
from ..ops.block_diag import LaneSegments, block_diag_cmm, unpack
from ..ops.dense import dense_assemble
from ..ops.gmres import gmres_solve_op
from ..ops.kernels import default_device
from ..ops.lane_route import lane_gather, lane_scatter, make_route
from ..ops.plane_rhs import plane_wave_rhs
from ..special._family import spherical_jh_all, spherical_jh_scaled
from ..translation._ops import check_method, translation_matrix
from ..translation._rotation import _sandwich, rotation_d, unique_radii
from ..translation._scaled import coax_fold_packed, graf_2d_folded, sr_banded_folded


@dataclass(frozen=True)
class BIEMResultCalculator:
    """Solved BIEM state; `uscat` evaluates the scattered field.

    Tensors live on the device the solve ran on; `relres`/`iters` are the
    GMRES diagnostics per batch system.
    """

    centers: Any
    radii: Any
    k: Any
    eta: Any
    density: Any
    matrix: Any = None
    c: Any = None
    uin: Any = None
    n_end: int = 0
    kind: str = "outer"
    relres: Any = None
    iters: Any = None

    def uscat(self, x, /, far_field=False, per_ball=False, expand_x=True):
        from ._eval import biem_u

        return biem_u(
            self, x, far_field=far_field, per_ball=per_ball, expand_x=expand_x
        )

    @classmethod
    def from_numpy(cls, c, n_end, centers, radii, k, eta, density, **kw):
        """Result from numpy arrays (see convert.from_numpy)."""
        from ..convert import from_numpy

        return from_numpy(c, n_end, centers, radii, k, eta, density, **kw)


def _complex_of(rdt):
    return torch.complex128 if rdt == torch.float64 else torch.complex64


def _device_of(*xs):
    """The device of the first tensor argument; the card when none is a
    tensor (CPU tensors are how a caller asks for the CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default_device()


def _tensor(x, device, name=None):
    """x as a floating or complex tensor on device; with a name, real
    (a complex value raises ValueError naming it)."""
    t = torch.as_tensor(x, device=device)
    if name is not None and t.is_complex():
        raise ValueError(f"{name} must be real")
    return t if t.is_floating_point() or t.is_complex() else t.to(torch.float64)


def _check_biem_inputs(c, centers, radii, k, eta, alpha, beta):
    """Validate inputs and bring them to tensors on one device.

    Returns (centers [..., B, d], radii [..., B], k [...] (real or
    complex), eta [...], alpha, beta (complex, broadcastable to [..., B]),
    real dtype).
    """
    dev = _device_of(k, radii, centers, eta, alpha, beta)
    k = _tensor(k, dev)
    radii = _tensor(radii, dev, "radii")
    centers = _tensor(centers, dev, "centers")
    rdt = torch.promote_types(torch.promote_types(radii.dtype, k.real.dtype), torch.float32)
    if eta is None:
        eta = torch.ones((1,) * k.ndim, dtype=rdt, device=dev)
    else:
        eta = torch.as_tensor(eta, device=dev)
        if eta.is_complex():
            raise ValueError("The decoupling parameter eta must be real.")
    cdt = _complex_of(rdt)
    alpha = torch.as_tensor(alpha, dtype=cdt, device=dev)
    beta = torch.as_tensor(beta, dtype=cdt, device=dev)
    if alpha.ndim == 0:
        alpha = alpha.reshape((1,) * (k.ndim + 1))
    if beta.ndim == 0:
        beta = beta.reshape((1,) * (k.ndim + 1))

    if bool((eta == 0).any()):
        warnings.warn(
            "The solution may be incorrect if k is an eigenvalue of the "
            "interior Neumann Laplacian (eta = 0).",
            UserWarning,
            stacklevel=3,
        )
    if bool(((k.imag < 0) | (eta * k.real < 0)).any() if k.is_complex()
            else (eta * k < 0).any()):
        warnings.warn(
            "The solution may be incorrect if not (Im k >= 0 and "
            "eta Re k >= 0).",
            UserWarning,
            stacklevel=3,
        )
    if len({k.ndim, eta.ndim, centers.ndim - 2, radii.ndim - 1}) != 1:
        raise ValueError(
            f"k.ndim={k.ndim}, eta.ndim={eta.ndim}, centers.ndim-2="
            f"{centers.ndim - 2}, radii.ndim-1={radii.ndim - 1} are not the same."
        )
    try:
        torch.broadcast_shapes(
            k.shape, eta.shape, centers.shape[:-2], radii.shape[:-1],
            alpha.shape[:-1], beta.shape[:-1],
        )
    except RuntimeError as e:
        raise ValueError(
            "Shapes of k, eta, centers[:-2], radii[:-1], alpha[:-1], "
            f"beta[:-1] are not broadcastable: {tuple(k.shape)}, "
            f"{tuple(eta.shape)}, {tuple(centers.shape)}, {tuple(radii.shape)}, "
            f"{tuple(alpha.shape)}, {tuple(beta.shape)}"
        ) from e
    try:
        torch.broadcast_shapes(centers.shape[:-1], radii.shape, alpha.shape, beta.shape)
    except RuntimeError as e:
        raise ValueError(
            "centers.shape[:-1], radii.shape, alpha.shape, beta.shape are "
            f"not broadcastable: {tuple(centers.shape)}, {tuple(radii.shape)}, "
            f"{tuple(alpha.shape)}, {tuple(beta.shape)}"
        ) from e
    if centers.shape[-1] != c.c_ndim:
        raise ValueError(
            f"The last dimension of centers must be c_ndim={c.c_ndim}, "
            f"but got {centers.shape[-1]}"
        )
    return centers, radii, k, eta.to(rdt), alpha, beta, rdt


def _rhs_plane_wave(c, n_end, centers, radii, alpha, beta, kw, direction,
                    has_uin, has_grad):
    r"""Closed-form boundary-data expansion of a plane wave: [K, B, H].

    From the plane-wave expansion e^{i k x.d^} = A_d sum_h i^{n_h}
    j_{n_h}(k|x|) Y_h(x^) conj(Y_h(d^)):

      f_h(b) = -A_d i^{n_h} e^{i k d^.c_b} conj(Y_h(d^))
               (alpha_b j_{n_h}(k rho_b) + beta_b k j'_{n_h}(k rho_b))

    kw [K] (real or complex), direction [d, K] (unit), centers [B, d] or
    [K, B, d], radii/alpha/beta [K, B].  j and j' from one K5 launch, then
    KR (`ops/plane_rhs.py`; on CPU tensors its plain version): with k rho
    formed straight into the complex argument K5 reads, three launches.
    """
    z = torch.empty(radii.shape, dtype=_complex_of(radii.dtype), device=radii.device)
    torch.mul(kw[:, None], radii, out=z)
    j, jp, _, _ = spherical_jh_all(c.c_ndim, n_end, z)
    return plane_wave_rhs(c, n_end, j, jp, kw, direction, centers, alpha, beta, has_uin,
                          has_grad)


def _rhs_expansion(c, n_end, centers, radii, alpha, beta, uin, uin_grad, first):
    """Boundary-data expansion by quadrature on each sphere: [K, B, H].

    f_h(b) = integral of -(alpha_b u_in + beta_b du_in/dn) conj(Y_h) over
    sphere b, by the tree's product rule exact to degree 2 n_end - 1 (the
    JAX package's `_rhs_expansion`).  The callables receive x [d, Q, B,
    *first], `first` being the caller's batch shape, so closures that
    broadcast over k's own shape work unchanged; the projection is one
    product with the cached conj(Y) w [Q, H].  centers [B, d] or [K, B,
    d]; radii, alpha, beta [K, B] with K = prod(first).
    """
    from ..harmonics._expand import _quad_harmonics

    n_k, n_balls = radii.shape
    xhat, wy = _quad_harmonics(c, n_end, 2 * (n_end - 1) + 1, radii.dtype, radii.device)
    d, q = xhat.shape
    ones = (1,) * len(first)

    def by_ball(t):  # [K, B] -> [B, *first]
        return t.transpose(0, 1).reshape((n_balls,) + first)

    xhat_e = xhat.reshape((d, q, 1) + ones)
    if centers.ndim == 2:  # one geometry for the batch
        c_x = centers.T.reshape((d, 1, n_balls) + ones)
    else:  # [K, B, d] -> [d, 1, B, *first]
        c_x = centers.permute(2, 1, 0).reshape((d, 1, n_balls) + first)
    x = by_ball(radii) * xhat_e + c_x
    vals = torch.zeros((), dtype=wy.dtype, device=radii.device)
    if uin is not None:
        vals = vals - by_ball(alpha) * torch.as_tensor(uin(x)).to(wy.dtype)
    if uin_grad is not None:
        grad = torch.as_tensor(uin_grad(x)).to(wy.dtype)
        vals = vals - by_ball(beta) * (grad * xhat_e).sum(dim=0)
    vals = vals.expand((q, n_balls) + first).reshape(q, n_balls * n_k)
    f = torch.matmul(vals.T, wy)  # [B*K, H]
    return f.reshape(n_balls, n_k, -1).transpose(0, 1)


def _rhs_dispatch(c, n_end, centers, radii, alpha, beta, uin, uin_grad, first):
    """The right-hand side [K, B, H]: the closed form when both callables
    carry the same `plane_wave` tag, else the quadrature projection
    (`_rhs_expansion`), as the JAX package dispatches."""
    tag_u = getattr(uin, "_analytic", None)
    tag_g = getattr(uin_grad, "_analytic", None)
    tags = [t for f, t in ((uin, tag_u), (uin_grad, tag_g)) if f is not None]
    if not (tags and all(t is tags[0] for t in tags) and tags[0] is not None):
        return _rhs_expansion(c, n_end, centers, radii, alpha, beta, uin, uin_grad, first)
    _, kw, direction = tags[0]
    dev, rdt = radii.device, radii.dtype
    kw = kw.to(device=dev, dtype=_complex_of(rdt) if kw.is_complex() else rdt)
    kw = kw.broadcast_to(first).reshape(-1)
    direction = direction.to(device=dev, dtype=rdt)
    direction = direction[(slice(None),) + (None,) * (len(first) + 1 - direction.ndim)]
    direction = direction.broadcast_to((c.c_ndim,) + first).reshape(c.c_ndim, -1)
    return _rhs_plane_wave(
        c, n_end, centers, radii, alpha, beta, kw, direction,
        has_uin=uin is not None, has_grad=uin_grad is not None,
    )


def _radial_rows(c, n_end, radii, k, eta, alpha, beta):
    """Unscaled radial rows (sing, reg, blc), complex [K, B, H], from one
    K5 launch (unscaled mode): sing = alpha h_n + beta k h_n', reg =
    alpha j_n + beta k j_n', blc = i k^{d-2} rho^{d-1} (k j_n' - i eta j_n).
    radii/alpha/beta [K, B], k/eta [K]."""
    d = c.c_ndim
    n_idx = _degree_tables(c, n_end, radii.dtype, radii.device)[0]
    j, jp, h, hp = (t.index_select(-1, n_idx)
                    for t in spherical_jh_all(d, n_end, k[:, None] * radii))
    k_b = k[:, None, None]
    sing = alpha[..., None] * h + beta[..., None] * (hp * k_b)
    reg = alpha[..., None] * j + beta[..., None] * (jp * k_b)
    pref = (1j * k[:, None] ** (d - 2) * radii ** (d - 1))[..., None]
    blc = pref * k_b * jp - (pref * j) * (1j * eta)[:, None, None]
    return sing, reg, blc


def _radial_rows_scaled(c, n_end, radii, k, eta, alpha, beta):
    """Scale-compensated radial rows: three (mantissa, exponent) pairs.

    sing = alpha h_n + beta k h_n', reg = alpha j_n + beta k j_n',
    blc = i k^{d-2} rho^{d-1} (k j_n' - i eta j_n), each as mant * exp(e)
    with the exponents of the two terms of each sum folded at their
    maximum.  radii/alpha/beta [K, B], k/eta [K]; outputs [K, B, H].
    """
    d = c.c_ndim
    n_idx = _degree_tables(c, n_end, radii.dtype, radii.device)[0]
    (jm, je), (jpm, jpe), (hm, he), (hpm, hpe) = spherical_jh_scaled(
        d, n_end, k[:, None] * radii
    )

    def gat(t):
        return t.index_select(-1, n_idx)

    jmH, jpmH, hmH, hpmH = gat(jm), gat(jpm), gat(hm), gat(hpm)
    jeH, jpeH, heH, hpeH = gat(je), gat(jpe), gat(he), gat(hpe)
    k_b = k[:, None, None]

    e_sing = torch.maximum(heH, hpeH)
    sing_m = alpha[..., None] * (hmH * torch.exp(heH - e_sing)) + beta[..., None] * (
        (hpmH * torch.exp(hpeH - e_sing)) * k_b
    )
    e_reg = torch.maximum(jeH, jpeH)
    reg_m = alpha[..., None] * (jmH * torch.exp(jeH - e_reg)) + beta[..., None] * (
        (jpmH * torch.exp(jpeH - e_reg)) * k_b
    )
    pref = (1j * k[:, None] ** (d - 2) * radii ** (d - 1))[..., None]
    e_blc = e_reg
    blc_m = pref * (
        k_b * (jpmH * torch.exp(jpeH - e_blc))
        - (jmH * torch.exp(jeH - e_blc)) * (1j * eta[:, None, None])
    )
    return (sing_m, e_sing), (reg_m, e_reg), (blc_m, e_blc)


def _radial_factors(c, n_end, radii, k, eta, alpha, beta, stable):
    """(rowf, colf, diag [K, B, H], fold): the row factor reg, the column
    factor blc and the diagonal sing * blc of the system, and the exponents
    that the (S|R) table must carry.

    stable=False: the unscaled radial rows and fold None.  stable=True: each
    row as mantissa x exponent; the ball-maximum exponents fold = (e_r_max,
    e_b_max) [K, H] go into the (S|R) table and the per-ball deficits
    exp(e - max_b e) <= 1 ride the row and column factors (the JAX
    package's unique-offset fold; for uniform radii the deficits are 1).
    """
    if not stable:
        sing, rowf, colf = _radial_rows(c, n_end, radii, k, eta, alpha, beta)
        return rowf, colf, sing * colf, None
    (sing_m, e_s), (reg_m, e_r), (blc_m, e_b) = _radial_rows_scaled(
        c, n_end, radii, k, eta, alpha, beta
    )
    # the diagonal entry is physically bounded; its factors are not
    diag = (sing_m * blc_m) * torch.exp(e_s + e_b)
    e_r_max, e_b_max = e_r.amax(dim=-2), e_b.amax(dim=-2)  # [K, H]
    rowf = reg_m * torch.exp(e_r - e_r_max[:, None, :])
    colf = blc_m * torch.exp(e_b - e_b_max[:, None, :])
    return rowf, colf, diag, (e_r_max, e_b_max)


@lru_cache(maxsize=32)
def _degree_tables(c, n_end, dtype, device):
    """(n_idx [H] int64, each flat harmonic's root degree; starts [n_end]
    int64, each degree's first harmonic; pm [H] in the real `dtype`, the
    mirror parity (-1)^n) on `device`: every k-block reads them, so they
    are copied to the card once."""
    n_root = basis(c, n_end).n_root
    return (torch.as_tensor(n_root, dtype=torch.long, device=device),
            torch.as_tensor(np.searchsorted(n_root, np.arange(n_end)), device=device),
            torch.as_tensor(1.0 - 2.0 * (n_root % 2), dtype=dtype, device=device))


def _geometry_key(centers_np):
    """A geometry's cache key: the bytes and shape of its float64 centers."""
    t = np.ascontiguousarray(centers_np, dtype=np.float64)
    return t.tobytes(), t.shape


def _offsets(centers_np):
    """(uniq [NO, d], pid [B, B], uniq_r [NR], r_inv [NO]) on the host: the
    distinct b < b' offset vectors c_b - c_b' (rounded to 12 decimals, so a
    lattice's repeats merge), each pair's index into them (the mirror b > b'
    pair sharing its pair's; the diagonal 0), their distinct lengths and
    each offset's index into those.  Cached on the centers' values (every
    k-block of a sweep asks again): the arrays are shared, never written."""
    return _offsets_of(*_geometry_key(centers_np))


@lru_cache(maxsize=16)
def _offsets_of(t_bytes, shape):
    centers_np = np.frombuffer(t_bytes, dtype=np.float64).reshape(shape)
    n_balls = centers_np.shape[0]
    bu, bv = np.triu_indices(n_balls, k=1)
    uniq, inv = np.unique(np.round(centers_np[bu] - centers_np[bv], 12), axis=0,
                          return_inverse=True)
    pid = np.zeros((n_balls, n_balls), np.int64)
    pid[bu, bv] = inv.reshape(-1)
    pid[bv, bu] = inv.reshape(-1)
    uniq_r, r_inv = unique_radii(np.linalg.norm(uniq, axis=1))
    return uniq, pid, uniq_r, r_inv


@dataclass(frozen=True)
class PairRouting:
    """Compacted pair lanes of the matrix-free matvec (see `_pair_routing`)."""

    uniq: np.ndarray  # [NO, d] offset vector per slot (unit dummies pad)
    lane: np.ndarray  # [L] padded lane index slot * 2 p_max + p of each lane
    src: np.ndarray  # [L] source row of [z; z*pm]: b' or B + b
    dst: np.ndarray  # [L] destination ball
    dn: np.ndarray  # [L] bool: mirror lane (parity applied to its output)
    slot_ptr: np.ndarray  # [NO + 1] lanes of each slot (CSR over lanes)
    p_max: int
    uniq_r: np.ndarray | None  # [NR] distinct pair distances (radius slots)
    g_max: int | None  # offset slots per distance (radius slots)

    @property
    def rad_ptr(self):
        """[NR + 1] lanes of each radius: its g_max slots are contiguous
        (radius slots only)."""
        return self.slot_ptr[:: self.g_max]


def _pair_routing(centers_np, radius_slots=True):
    """Host-side pair routing for the matrix-free matvec.

    The b < b' offset vectors are deduplicated.  radius_slots=False (the
    offset-table matvec): each distinct offset is one SLOT, in `_offsets`'
    order, so slot o reads the table's offset o.  radius_slots=True (the
    factored matvec; the default here, as the port's main path): the
    offsets are ordered by |t| and each distinct radius owns g_max slots
    (dummy slots route nothing), so the coaxial factor applies per
    contiguous radius group.  In the padded layout of the JAX package lane
    i = slot * 2 p_max + p: the first p_max lanes of a slot hold its
    b < b' pairs, the next p_max their mirrors.  Only the lanes that route
    a pair are kept, in that order: every slot's lanes, and every
    radius's, form one contiguous segment (`slot_ptr`, `rad_ptr`).
    Integer index tables replace the JAX package's one-hot gather/scatter
    matrices.
    """
    n_balls = centers_np.shape[0]
    bu, bv = np.triu_indices(n_balls, k=1)
    uniq, pid, uniq_r, r_inv = _offsets(centers_np)
    inv = pid[bu, bv]
    slot_groups = [np.nonzero(inv == o)[0] for o in range(len(uniq))]
    slot_uniq, g_max = uniq, None
    if radius_slots:
        n_rad = len(uniq_r)
        g_max = int(np.max(np.bincount(r_inv)))
        slot_uniq = np.zeros((n_rad * g_max, uniq.shape[1]))
        # dummy direction: the radius along the first axis
        slot_uniq[:, 0] = np.repeat(uniq_r, g_max)
        groups, slot_groups = slot_groups, [np.zeros((0,), np.int64)] * (n_rad * g_max)
        fill = np.zeros(n_rad, np.int64)
        for o in range(len(uniq)):
            r = r_inv[o]
            s = r * g_max + fill[r]
            fill[r] += 1
            slot_uniq[s] = uniq[o]
            slot_groups[s] = groups[o]
    else:
        uniq_r = None
    p_max = max(len(g) for g in slot_groups)
    n_slots = len(slot_groups)
    up_src = -np.ones((n_slots, p_max), np.int64)  # b' (gather z)
    up_dst = -np.ones((n_slots, p_max), np.int64)  # b  (scatter y)
    for o, g in enumerate(slot_groups):
        up_src[o, : len(g)] = bv[g]
        up_dst[o, : len(g)] = bu[g]
    # mirror pairs swap roles and read the parity-flipped rows B + b
    dn_src = np.where(up_dst >= 0, up_dst + n_balls, -1)
    src = np.concatenate([up_src, dn_src], axis=1).ravel()
    dst = np.concatenate([up_dst, up_src], axis=1).ravel()
    lane = np.nonzero(src >= 0)[0]
    dn = (lane % (2 * p_max)) >= p_max
    slot_ptr = np.searchsorted(lane // (2 * p_max), np.arange(n_slots + 1))
    return PairRouting(slot_uniq, lane, src[lane], dst[lane], dn, slot_ptr, p_max,
                       uniq_r, g_max)


# The matrix-free operators' per-geometry tables, cached on the centers'
# values as `rotation_d` caches D: a sweep's k-blocks share one geometry,
# so from the second block on neither `_pair_routing` nor `make_route`
# runs.
@lru_cache(maxsize=16)
def _routing_of(t_bytes, shape, radius_slots):
    """`_pair_routing` of the centers with key (t_bytes, shape)."""
    centers_np = np.frombuffer(t_bytes, dtype=np.float64).reshape(shape)
    return _pair_routing(centers_np, radius_slots)


@lru_cache(maxsize=16)
def _route_of(t_bytes, shape, radius_slots, device, o0, o1):
    """(KC's tables `make_route` of the lanes of slots [o0, o1), those
    lanes' padded indices less slot o0's first, int64) on `device`."""
    routing = _routing_of(t_bytes, shape, radius_slots)
    lanes = slice(routing.slot_ptr[o0], routing.slot_ptr[o1])
    route = make_route(routing.src[lanes], routing.dst[lanes], routing.dn[lanes], shape[0],
                       device)
    lane = torch.as_tensor(routing.lane[lanes] - o0 * 2 * routing.p_max, device=device)
    return route, lane


@lru_cache(maxsize=16)
def _factored_geometry(t_bytes, shape, dtype, device):
    """The factored operator's tables of one geometry: (routing, KC's
    route, D's and X's lane segments, the distinct distances [NR] in the
    real `dtype` on `device`)."""
    routing = _routing_of(t_bytes, shape, True)
    route, _ = _route_of(t_bytes, shape, True, device, 0, len(routing.uniq))
    return (routing, route, LaneSegments(tuple(int(v) for v in routing.slot_ptr)),
            LaneSegments(tuple(int(v) for v in routing.rad_ptr)),
            torch.as_tensor(routing.uniq_r, dtype=dtype, device=device))


def _matfree_operator(c, n_end, centers_np, radii, k, eta, alpha, beta, method=None,
                      sr_map=None, stable=False):
    """The unique-offset matrix-free operator: (mv, diag) on [K, B*H] vectors.

    The JAX package's dispatch: scale-compensated with no `sr_map` on a
    'b'/'bp'-rooted tree in d >= 3, the factored operator
    (`_factored_operator`: SR is never formed); otherwise (2D, or
    unscaled, or an `sr_map`) the offset-table operator
    (`_offset_table_operator`), whose per-offset (S|R) table `sr_map` may
    transform once it is built.
    """
    if stable and sr_map is None and c.c_ndim >= 3 and c.root.kind in ("b", "bp"):
        return _factored_operator(c, n_end, centers_np, radii, k, eta, alpha, beta)
    return _offset_table_operator(c, n_end, centers_np, radii, k, eta, alpha, beta,
                                  method, sr_map, stable)


def _offset_table_operator(c, n_end, centers_np, radii, k, eta, alpha, beta, method,
                           sr_map, stable, offsets=None, with_diag=True):
    """The offset-table matrix-free operator: (mv, diag) on [K, B*H] vectors.

    The table [K, NO, H, H] and the row, column and diagonal factors are
    the dense route's (`_assembly_parts`: unscaled, or with the ball-max
    fold and the per-ball deficits on the factors), built once per k-block.
    One matvec routes colf * x into the compacted offset-slot lanes (KC),
    spreads them into the padded [K, NO, 2 p_max, H] layout, applies each
    offset's table to all its lanes in one batched product (cuBLAS, the
    table read through its transpose in place), takes the compacted lanes
    back and sums them per sphere with the parity and the diagonal (KC).

    offsets (a slice of the offset ids, `_offsets`' order) builds the table
    of those offsets alone and routes only their lanes: mv is then that
    share of the coupling (the offset-sharded solve, parallel.sharded_solve,
    sums the shares across ranks), with the diagonal term only where
    with_diag.  diag is always the whole system's diagonal; mv.stored_bytes
    is the table's size.
    """
    n_k, n_balls = radii.shape
    dev = radii.device
    key = _geometry_key(centers_np)
    routing = _routing_of(*key, False)
    if offsets is None:
        table, _, rowf, colf, pm, diag = _assembly_parts(
            c, n_end, centers_np, radii, k, eta, alpha, beta, method, stable)
        o0, o1 = 0, len(routing.uniq)
    else:
        rowf, colf, diag, fold = _radial_factors(c, n_end, radii, k, eta, alpha, beta,
                                                 stable)
        pm = _degree_tables(c, n_end, radii.dtype, dev)[2]
        uniq = routing.uniq[offsets]
        uniq_r, r_inv = unique_radii(np.linalg.norm(uniq, axis=1))
        table = _offset_table(c, n_end, uniq, uniq_r, r_inv, k, fold, method)
        o0 = offsets.start or 0
        o1 = o0 + len(uniq)
    if sr_map is not None:
        table = sr_map(table)
    h_num = rowf.shape[-1]
    n_off, lps = table.shape[1], 2 * routing.p_max
    rowf, colf, diag = (
        t.expand(n_k, n_balls, h_num).contiguous() for t in (rowf, colf, diag)
    )
    diag_mv = diag if with_diag else torch.zeros_like(diag)
    if n_off == 0:  # a share with no offsets: the diagonal term alone

        def mv(x_flat):
            return (diag_mv * x_flat.reshape(n_k, n_balls, h_num)).reshape(n_k, -1)

    else:
        route, lane = _route_of(*key, False, dev, o0, o1)
        # y[k, o, p] = SR[k, o] w[k, o, p]: w @ SR^T, SR^T a view of the table
        sr_t = table.reshape(n_k * n_off, h_num, h_num).transpose(1, 2)
        # the padding lanes stay zero: index_copy_ writes the routed lanes only
        padded = table.new_zeros((n_k, n_off * lps, h_num))

        def mv(x_flat):
            x = x_flat.reshape(n_k, n_balls, h_num)
            y = _table_product(lane_gather(x, colf, pm, route), padded, lane, sr_t)
            out = lane_scatter(y, x, diag_mv, rowf, pm, route)
            return out.reshape(n_k, n_balls * h_num)

    mv.stored_bytes = table.numel() * table.element_size()
    return mv, diag.reshape(n_k, n_balls * h_num)


def _table_product(lanes, padded, lane, sr_t):
    """SR[k, o] applied to every compacted lane [K, L, H] of offset o: the
    lanes spread into the zero-padded [K, NO * 2 p_max, H] buffer at their
    padded index `lane`, one batched product over K * NO with the table's
    transposed view sr_t [K * NO, H', H] (cuBLAS reads it in place), and
    the compacted lanes taken back."""
    n_k, n_pad, h_num = padded.shape
    padded.index_copy_(1, lane, lanes)
    y = torch.bmm(padded.view(sr_t.shape[0], -1, h_num), sr_t)
    return y.view(n_k, n_pad, h_num).index_select(1, lane)


def _factored_operator(c, n_end, centers_np, radii, k, eta, alpha, beta):
    """The factored matrix-free operator: (mv, diag) on [K, B*H] vectors."""
    h_num = basis(c, n_end).num
    n_balls = centers_np.shape[0]
    n_k = k.shape[0]
    dev, rdt = radii.device, radii.dtype
    reg_row, blc_col, diag, (e_r_max, e_b_max) = _radial_factors(
        c, n_end, radii, k, eta, alpha, beta, stable=True)

    # the geometry's routing, KC's tables, the lane segments and the
    # distances: built at its first k-block, then cached
    routing, route, d_seg, x_seg, uniq_r = _factored_geometry(
        *_geometry_key(centers_np), rdt, dev)

    # the coaxial factor with the degree-level fold of the ball-max
    # exponents (constant on degree blocks, which D preserves:
    # F .* (D X D^H) = D (F .* X) D^H), packed into its child-state
    # blocks: K5 + K2, no [K, NR, H, H] tensor
    _, starts, pm = _degree_tables(c, n_end, rdt, dev)
    x_blocks = coax_fold_packed(
        c, n_end, uniq_r, k, e_r_max[:, starts].contiguous(), e_b_max[:, starts].contiguous(),
    )
    d_blocks = rotation_d(c, n_end, routing.uniq, rdt, dev).packed
    blc_col, reg_row, diag = (
        t.expand(n_k, n_balls, h_num).contiguous() for t in (blc_col, reg_row, diag)
    )

    def mv(x_flat):
        x = x_flat.reshape(n_k, n_balls, h_num)
        lanes = lane_gather(x, blc_col, pm, route)  # [K, L, H], L compacted
        w = block_diag_cmm(d_blocks, lanes, d_seg, adjoint=True)
        v = block_diag_cmm(x_blocks, w, x_seg)  # X reads its permutation itself
        y = block_diag_cmm(d_blocks, v, d_seg)
        out = lane_scatter(y, x, diag, reg_row, pm, route)
        return out.reshape(n_k, n_balls * h_num)

    return mv, diag.reshape(n_k, n_balls * h_num)


def _assemble(c, n_end, centers_np, radii, k, eta, alpha, beta, method=None,
              stable=False, pair_major=False, rows=None):
    """The dense system matrix: complex [K, B, H, B', H'], or pair-major
    [K, B, B', H, H'] (biem_helmholtz_sphere_tpu: `_assemble`, block-gather
    branch and the single-sphere diagonal): the KD kernel (ops/dense.py)
    on `_assembly_parts`.  rows = (r0, r1): only the rows r0 <= b H + h <
    r1 of the [B H, B' H'] matrix, [K, r1 - r0, B', H'] (the row-sharded
    solve, parallel.sharded_solve)."""
    return dense_assemble(
        *_assembly_parts(c, n_end, centers_np, radii, k, eta, alpha, beta, method, stable),
        pair_major=pair_major, rows=rows,
    )


def _offsets_per_k(centers_np):
    """`_offsets` of each geometry of centers_np [K, B, d], padded to the
    largest counts: (uniq [K, NO, d], pid [K, B, B], uniq_r [K, NR],
    r_inv [K, NO]).  A padding offset repeats the geometry's first (it is
    built and never gathered)."""
    per = [_offsets(c_k) for c_k in centers_np]
    n_off = max(len(p[0]) for p in per)
    n_rad = max(len(p[2]) for p in per)

    def pad(a, n):
        return np.concatenate([a, np.repeat(a[:1], n - len(a), axis=0)])

    return (np.stack([pad(p[0], n_off) for p in per]), np.stack([p[1] for p in per]),
            np.stack([pad(p[2], n_rad) for p in per]),
            np.stack([pad(p[3], n_off) for p in per]))


def _offset_table(c, n_end, uniq, uniq_r, r_inv, k, fold, method=None):
    """The (S|R) of each distinct offset: complex [K, NO, H, H].

    uniq [NO, d] (one geometry) or [K, NO, d] (each k its own), their
    distinct lengths uniq_r [NR] or [K, NR] and each offset's index r_inv
    into them (host, as `_offsets` gives them); k real or complex [K].
    fold None: translation_matrix(method=method), unscaled (Graf's closed
    form through KG in 2D, the rotation + coaxial K2 route on 'b'/'bp'
    roots in d >= 3, the band scan through KS on other roots).
    fold = (e_r, e_b) [K, H], the ball-maximum exponents: the table with
    them folded in, scale-compensated.  In 2D that is KG (K5's d = 2 h
    mantissas and exponents, the i-power, the phase and the fold in one
    launch); on 'b'/'bp' roots in d >= 3 K2 folds at the coaxial factor
    (the fold is constant on degree blocks, which the rotation preserves)
    and the rotation sandwich D X D^H follows by degree groups; on other
    roots KS folds at the store of the band scan.  The dense, the
    offset-table and the lattice routes all build their table here.
    """
    dev = k.device
    rdt = k.real.dtype
    t_cart = torch.as_tensor(np.moveaxis(uniq, -1, 0).copy(), dtype=rdt, device=dev)
    if fold is None:  # [d, NO] or [d, K, NO]
        return translation_matrix(c, t_cart, n_end, k[:, None], kind="SR", method=method)
    e_r, e_b = fold
    if c.c_ndim == 2:
        return graf_2d_folded(c, t_cart, n_end, k, e_r, e_b)
    if c.root.kind not in ("b", "bp"):
        return sr_banded_folded(c, t_cart, n_end, k, e_r, e_b)
    starts = _degree_tables(c, n_end, rdt, dev)[1]
    x = coax_fold_packed(c, n_end, torch.as_tensor(uniq_r, dtype=rdt, device=dev), k,
                         e_r[:, starts].contiguous(), e_b[:, starts].contiguous())
    r_inv = torch.as_tensor(r_inv, device=dev)
    coax = unpack(x)
    coax = (coax[torch.arange(k.shape[0], device=dev)[:, None], r_inv] if uniq.ndim == 3
            else coax[:, r_inv])
    return _sandwich(coax, rotation_d(c, n_end, uniq, rdt, dev))


def _assembly_parts(c, n_end, centers_np, radii, k, eta, alpha, beta, method=None,
                    stable=False):
    """KD's arguments (table [K, NO, H, H], pid [B, B] or [K, B, B], rowf,
    colf [K, B, H], sgn [H], diag [K, B, H]) for the dense matrix.

    centers_np [B, d] (one geometry) or [K, B, d] (geometry along the
    batch; host); radii/alpha/beta [K, B], k/eta [K] (k real or complex).
    The (S|R) is built once per distinct offset of each geometry (per k
    when the geometry varies: `_offsets_per_k`); KD gathers it per pair,
    with that k's pair map, the row factor reg, the column factor blc and
    the mirror parity.
    stable=False: the unscaled radial rows and
    translation_matrix(method=method), which overflow float32 from n_end ~
    k t_min + 20 as the JAX package's do.  stable=True: each factor as
    mantissa x exponent; the ball-maximum exponents fold into the coaxial
    factor (K2, exactly as on the factored route: the fold is constant on
    degree blocks, which the rotation preserves) and the per-ball deficits
    exp(e - max_b e) <= 1 ride the row and column factors.  For uniform
    radii the deficits are 1 and this is the JAX package's unique-offset
    fold; otherwise it is the same matrix in exact arithmetic as its
    per-pair exponents.
    """
    n_k, n_balls = radii.shape
    dev, rdt = radii.device, radii.dtype
    h_num = basis(c, n_end).num
    sgn = _degree_tables(c, n_end, rdt, dev)[2]
    rowf, colf, diag, fold = _radial_factors(c, n_end, radii, k, eta, alpha, beta, stable)
    if n_balls == 1:
        table = torch.zeros((n_k, 0, h_num, h_num), dtype=rowf.dtype, device=dev)
        pid = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    else:
        per_k = centers_np.ndim == 3
        uniq, pid_np, uniq_r, r_inv = (_offsets_per_k if per_k else _offsets)(centers_np)
        pid = torch.as_tensor(pid_np, device=dev)
        table = _offset_table(c, n_end, uniq, uniq_r, r_inv, k, fold, method)
    return table, pid, rowf, colf, sgn, diag


def _route(solver, n_balls, n_sys, rdt, device, has_rhs, force_matrix, centers_np):
    """biem_helmholtz_sphere_tpu's route for a solve, by its thresholds.

    Returns "diagonal" (one sphere with a right-hand side), "matrix" (no
    right-hand side: the matrix alone), "lu", "gmres" (dense GMRES on the
    pair-major matrix), "matfree" (the unique-offset matrix-free GMRES) or
    "lattice" (the lattice-FFT matrix-free GMRES); centers_np [B, d], or
    [K, B, d] for geometry along the batch (then only the dense routes
    are open).  On an accelerator LU
    takes up to 6144 unknowns and the dense matrix up to 6 GB; on the CPU
    12288 and 40 GB.  "auto" beyond the LU tier prefers matrix-free for
    8 <= B < 64 spheres with at most half as many distinct offsets as
    pairs, and the lattice form from B = 64 where the centers form a
    lattice (`_lattice.lattice_routing`); other geometries of 64 or more
    spheres go on to the same routes as fewer.
    """
    from ._lattice import lattice_routing

    if has_rhs and n_balls == 1 and not force_matrix:
        return "diagonal"
    accel = device.type != "cpu"
    dense_bytes = (2 if rdt == torch.float32 else 4) * 4 * n_sys * n_sys
    lu_limit = 6144 if accel else 12288
    use_matfree = solver == "matfree" or (
        solver == "auto" and dense_bytes > (6e9 if accel else 40e9))
    # geometry that varies along the batch (centers_np [K, B, d]) is never
    # matrix-free, as in the JAX package
    matfree_ok = has_rhs and not force_matrix and n_balls > 1 and centers_np.ndim == 2
    if (matfree_ok and n_balls >= 64 and (use_matfree or solver == "auto")
            and lattice_routing(centers_np) is not None):
        return "lattice"
    if (matfree_ok and not use_matfree and solver == "auto" and 8 <= n_balls < 64
            and n_sys > lu_limit):
        n_pairs = n_balls * (n_balls - 1) // 2
        use_matfree = len(_offsets(centers_np)[0]) * 2 <= n_pairs
    if matfree_ok and use_matfree:
        return "matfree"
    if not has_rhs:
        return "matrix"
    if use_matfree or solver == "gmres" or (solver == "auto" and n_sys > lu_limit):
        return "gmres"
    return "lu"


def _pairs_operator(a5):
    """(mv, diag) of the pair-major matrix a5 [K, B, B', H, H'] on [K, B*H]
    vectors: a product batched over the source ball b', then a sum over it
    (biem_helmholtz_sphere_tpu: ops/cplx.py::gmres_solve_pairs)."""
    n_k, n_balls, _, h_num, _ = a5.shape
    diag = torch.diagonal(torch.diagonal(a5, dim1=1, dim2=2), dim1=1, dim2=2)  # [K, B, H]

    def mv(x_flat):
        x = x_flat.reshape(n_k, 1, n_balls, h_num, 1)
        return (a5 @ x).sum(dim=2).reshape(n_k, n_balls * h_num)

    return mv, diag.reshape(n_k, n_balls * h_num)


def biem(
    c,
    /,
    *,
    centers,
    radii,
    k,
    n_end,
    alpha=1.0,
    beta=0.0,
    uin=None,
    uin_grad=None,
    eta=None,
    kind: Literal["inner", "outer"] = "outer",
    force_matrix=False,
    translational_coefficients_method=None,
    solver="auto",
    stable=None,
    density0=None,
):
    """Solve the Helmholtz BIEM for non-overlapping spheres.

    Same parameters, shapes, routes and result as biem_helmholtz_sphere_tpu's
    `biem` ([..., B, d] centers, [..., B] radii, [...] k, [...(,B)]
    alpha/beta, [...] eta; leading batch axes broadcast, and one geometry
    is shared by the batch); complex outputs are native torch complex
    tensors on the device of the input tensors; with no tensor input
    (numpy or Python numbers) the solve runs on the card, and raises where
    CUDA is absent.  Ported for every tree: 2D ('a') and any tree of 'b',
    'bp' and 'c' nodes in d >= 3 (ba, bpa, bba, bpbpa, bbba, caa, bcaa,
    cbaba, ...), real or complex k, and geometry shared by the batch or
    varying along it:

    * solver="auto" picks the JAX package's route (`_route`): the diagonal
      solve for one sphere; LU up to 6144 unknowns on the card (12288 on
      the CPU); the lattice-FFT GMRES for 64 or more spheres on a lattice;
      the matrix-free GMRES for 8 <= B < 64 spheres with repeated offsets
      beyond that; dense GMRES while the matrix fits 6 GB (40 GB on the
      CPU), matrix-free beyond; geometry that varies along the batch
      takes LU or dense GMRES only;
    * "direct" (LU), "gmres" (dense GMRES) and "matfree" force a route;
      "matfree" takes the lattice form from 64 spheres on a lattice, else
      the factored operator when scale-compensated on a 'b'/'bp'-rooted
      tree in d >= 3 and the per-offset (S|R) table otherwise (2D, 'c'
      roots, unscaled; `_matfree_operator`);
    * stable (default: True in float32, False in float64) selects the
      scale-compensated assembly;
    * uin/uin_grad: the closures of one `plane_wave` call take the closed
      form; any other callables (`point_source`, user functions of x
      [d, Q, B, ...batch]) take the quadrature projection;
    * with no incident field the result holds the matrix alone
      (calc.matrix [..., B, H, B', H'], density None); force_matrix builds
      it on every route and solves with it;
    * translational_coefficients_method is validated as
      translation_matrix does, used by the plain (stable=False) routes and
      ignored by the scale-compensated ones: "gumerov" builds the (S|R)
      table of the dense, offset-table and lattice routes by rotation +
      the Gumerov-Duraiswami ladders on "ba"/"bpa" and raises ValueError
      on other trees, as the JAX package's does.

    relres/iters are the GMRES diagnostics (None on the direct routes);
    density0 warm-starts GMRES.

    The reference README problem (two sound-soft unit spheres at
    (0, +-2, 0), k=1, plane wave along x0), on the default route, a direct
    LU in float64:

    >>> import torch
    >>> from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    >>> from biem_helmholtz_sphere_tpu_torch.coords import (
    ...     create_from_branching_types)
    >>> c = create_from_branching_types("ba")
    >>> f64 = dict(dtype=torch.float64)
    >>> uin, _ = plane_wave(k=torch.tensor(1.0, **f64),
    ...                     direction=torch.tensor([1.0, 0.0, 0.0], **f64))
    >>> calc = biem(c, centers=torch.tensor([[0., 2., 0.], [0., -2., 0.]], **f64),
    ...             radii=torch.ones(2, **f64), k=torch.tensor(1.0, **f64),
    ...             n_end=6, uin=uin)
    >>> print(f"{complex(calc.uscat(torch.zeros(3, 1, **f64))[0]):.5f}")
    -0.74133-0.66966j
    """
    if solver not in ("auto", "direct", "gmres", "matfree"):
        raise ValueError(f"unknown solver {solver!r}")
    method = translational_coefficients_method
    check_method("SR", method)
    centers, radii, k, eta, alpha, beta, rdt = _check_biem_inputs(
        c, centers, radii, k, eta, alpha, beta
    )
    if stable is None:
        stable = rdt == torch.float32
    n_balls = radii.shape[-1]
    h_num = basis(c, n_end).num
    n_sys = n_balls * h_num
    has_rhs = uin is not None or uin_grad is not None
    if has_rhs and bool((alpha != 0).any()) and uin is None:
        raise ValueError(
            "alpha is not zero, but uin is None. uin must be provided to "
            "compute the boundary condition."
        )
    if has_rhs and bool((beta != 0).any()) and uin_grad is None:
        raise ValueError(
            "beta is not zero, but uin_grad is None. uin_grad must be "
            "provided to compute the boundary condition."
        )
    # the leading batch axes, flattened to one axis K inside
    batch = tuple(torch.broadcast_shapes(
        k.shape, eta.shape, centers.shape[:-2], radii.shape[:-1], alpha.shape[:-1],
        beta.shape[:-1]))
    n_k = int(np.prod(batch, dtype=np.int64))
    centers_np = centers.detach().cpu().numpy().astype(np.float64)
    flat = centers_np.reshape((-1,) + centers_np.shape[-2:])
    if (flat == flat[:1]).all():
        centers_np = flat[0]  # one geometry for the batch: [B, d]
    else:  # each k its own: [K, B, d]
        centers_np = np.array(np.broadcast_to(centers_np, batch + centers_np.shape[-2:]))
        centers_np = centers_np.reshape((n_k,) + centers_np.shape[-2:])
    route = _route(solver, n_balls, n_sys, rdt, radii.device, has_rhs, force_matrix,
                   centers_np)

    k = k.expand(batch)
    k_f = k.to(_complex_of(rdt) if k.is_complex() else rdt).reshape(n_k)
    eta_f = eta.expand(batch).reshape(n_k)
    radii_f = radii.to(rdt).expand(batch + (n_balls,)).reshape(n_k, n_balls)
    alpha_f = alpha.expand(batch + (n_balls,)).reshape(n_k, n_balls)
    beta_f = beta.expand(batch + (n_balls,)).reshape(n_k, n_balls)
    # the RHS reads the centers where they already lie (no copy from the host)
    if centers_np.ndim == 2:
        centers_t = centers.reshape((-1,) + centers.shape[-2:])[0].to(rdt)
    else:
        centers_t = centers.to(rdt).expand(batch + centers.shape[-2:]).reshape(
            centers_np.shape)
    args = (c, n_end, radii_f, k_f, eta_f, alpha_f, beta_f)

    f_exp = None
    if has_rhs:
        f_exp = _rhs_dispatch(
            c, n_end, centers_t, radii_f, alpha_f, beta_f, uin, uin_grad, batch
        ).reshape(n_k, n_sys)
    x0 = None
    if density0 is not None and route in ("gmres", "matfree", "lattice"):
        x0 = torch.as_tensor(density0, device=radii.device).to(f_exp.dtype)
        x0 = x0.expand(batch + (n_balls, h_num)).reshape(n_k, n_sys)
    density = matrix = relres = iters = None
    if route == "diagonal":
        if stable:
            (sing_m, e_s), _, (blc_m, e_b) = _radial_rows_scaled(*args)
            density = f_exp / ((sing_m * blc_m) * torch.exp(e_s + e_b)).reshape(n_k, n_sys)
        else:
            sing, _, blc_v = _radial_rows(*args)
            density = f_exp / (blc_v * sing).reshape(n_k, n_sys)
    elif route in ("matfree", "lattice"):
        if route == "lattice":
            from ._lattice import lattice_operator

            mv, diag = lattice_operator(c, n_end, centers_np, *args[2:], method=method,
                                        stable=stable)
        else:
            mv, diag = _matfree_operator(c, n_end, centers_np, *args[2:], method=method,
                                         stable=stable)
        density, relres, iters = gmres_solve_op(mv, diag, f_exp, x0=x0)
    else:
        a = _assemble(c, n_end, centers_np, *args[2:], method=method, stable=stable,
                      pair_major=route == "gmres")
        if route == "gmres":
            mv, diag = _pairs_operator(a)
            density, relres, iters = gmres_solve_op(mv, diag, f_exp, x0=x0)
            a = a.transpose(2, 3)  # the [B, H, B', H'] view of the pair-major matrix
        elif route == "lu":
            density = torch.linalg.solve(a.reshape(n_k, n_sys, n_sys), f_exp)  # cuSOLVER
        matrix = a.reshape(batch + a.shape[1:])
    if density is not None:
        density = density.reshape(batch + (n_balls, h_num))
    if relres is not None:
        relres, iters = relres.reshape(batch), iters.reshape(batch)

    if uin is None:
        uin_wrapped = None
    else:

        def uin_wrapped(x, /, *, expand_x=True):
            x = torch.as_tensor(x, dtype=rdt, device=radii.device)
            if expand_x:
                x = x[(...,) + (None,) * len(batch)]
            return uin(x)

    return BIEMResultCalculator(
        c=c,
        centers=centers,
        radii=radii,
        k=k,
        eta=eta,
        density=density,
        matrix=matrix,
        uin=uin_wrapped,
        n_end=n_end,
        kind=kind,
        relres=relres,
        iters=iters,
    )
