r"""BIEM assembly and solve on the factored matrix-free route.

Combined-field indirect formulation: the unknown density on each sphere
is expanded in hyperspherical harmonics; on-sphere traces are diagonal per
harmonic (_layer.py) and inter-sphere coupling is the (S|R) translation
operator.  The system

  A[b,h;b',h'] = blc_{n'}(rho_b') * ( b == b' :
        delta_{hh'} (alpha_b h_n(k rho_b) + beta_b k h_n'(k rho_b))
      : (S|R)[h,h'](c_b - c_b') (alpha_b j_n(k rho_b) + beta_b k j_n'(k rho_b)) )

is never formed.  For 'b'-rooted trees in d >= 3 the scale-compensated
(S|R) factors as SR(t) = D(t^) X(|t|) D(t^)^H: D is the k-independent
rotation (built once per geometry and cached), X the coaxial factor per
distinct pair distance with the ball-maximum radial exponents folded in.
The k-dependent build runs the radial special functions (K5,
special/_family.py) and writes X straight into its packed blocks (K2,
translation/_scaled.py::coax_fold_packed).  One matvec routes the
spheres into the compacted pair lanes (KC), applies D^H, X and D to the
lanes (KB) and sums the lanes back into their destination spheres (KC); GMRES
(ops/gmres.py) solves the system.

This is the route `biem()` of biem_helmholtz_sphere_tpu takes at the
bench configuration (biem/_core.py: `_matfree_operator`, factored
branch).  Every other route raises NotImplementedError.
"""

import warnings
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Literal

import numpy as np
import torch

from ..harmonics._index import basis
from ..ops.block_diag import LaneSegments, block_diag_cmm, pack
from ..ops.gmres import gmres_solve_op
from ..ops.kernels import default_device
from ..ops.lane_route import lane_gather, lane_scatter, make_route
from ..special._family import spherical_jh_all, spherical_jh_scaled
from ..translation._ops import _a_const, ipow
from ..translation._rotation import rotation_matrix
from ..translation._scaled import coax_fold_packed

_ROUTES = "ROADMAP queue 1 item 8"
_TREES = "ROADMAP queue 1 item 9"


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


def _device_of(*xs):
    """The device of the first tensor argument; the card when none is a
    tensor (CPU tensors are how a caller asks for the CPU)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default_device()


def _real(x, device):
    t = torch.as_tensor(x, device=device)
    if t.is_complex():
        raise NotImplementedError(f"complex k is not ported yet ({_ROUTES})")
    return t if t.is_floating_point() else t.to(torch.float64)


def _check_biem_inputs(c, centers, radii, k, eta, alpha, beta):
    """Validate inputs and bring them to tensors on one device.

    Returns (centers [..., B, d], radii [..., B], k [...], eta [...],
    alpha, beta (complex, broadcastable to [..., B]), real dtype).
    """
    dev = _device_of(k, radii, centers, eta, alpha, beta)
    k = _real(k, dev)
    radii = _real(radii, dev)
    centers = _real(centers, dev)
    rdt = torch.promote_types(torch.promote_types(radii.dtype, k.dtype), torch.float32)
    if eta is None:
        eta = torch.ones((1,) * k.ndim, dtype=rdt, device=dev)
    else:
        eta = torch.as_tensor(eta, device=dev)
        if eta.is_complex():
            raise ValueError("The decoupling parameter eta must be real.")
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
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
    if bool((eta * k < 0).any()):
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

    kw [K], direction [d, K] (unit), centers [B, d], radii/alpha/beta [K, B].
    """
    from ..coords import from_cartesian
    from ..harmonics._eval import harmonics

    d = c.c_ndim
    dev = radii.device
    n_idx = torch.as_tensor(basis(c, n_end).n_root, dtype=torch.long, device=dev)
    j, jp, _, _ = spherical_jh_all(d, n_end, kw[:, None] * radii)
    term = 0.0
    if has_uin:
        term = term + alpha[..., None] * j.index_select(-1, n_idx)
    if has_grad:
        term = term + beta[..., None] * (jp.index_select(-1, n_idx) * kw[:, None, None])
    y_dir = harmonics(c, from_cartesian(c, direction), n_end)  # [K, H]
    cy = y_dir.conj() * ipow(n_idx, y_dir.dtype, dev) * (-_a_const(d))
    ip = direction.T @ centers.T  # [K, B]
    phase = torch.exp(1j * kw[:, None] * ip)
    return (phase[..., None] * term) * cy[:, None, :]


def _rhs_dispatch(c, n_end, centers, radii, alpha, beta, uin, uin_grad, n_k):
    """The analytic plane-wave right-hand side, when both callables carry
    the same `plane_wave` tag; any other incident field raises."""
    tag_u = getattr(uin, "_analytic", None)
    tag_g = getattr(uin_grad, "_analytic", None)
    tags = [t for f, t in ((uin, tag_u), (uin_grad, tag_g)) if f is not None]
    if not (tags and all(t is tags[0] for t in tags) and tags[0] is not None):
        raise NotImplementedError(
            "only a plane-wave incident field (plane_wave(...)) is ported; the "
            f"boundary-quadrature right-hand side is {_ROUTES}"
        )
    _, kw, direction = tags[0]
    dev, rdt = radii.device, radii.dtype
    kw = kw.to(device=dev, dtype=rdt).reshape(-1)
    direction = direction.to(device=dev, dtype=rdt).reshape(c.c_ndim, -1)
    kw = kw.expand(n_k) if kw.numel() == 1 else kw
    direction = direction.expand(c.c_ndim, n_k)
    return _rhs_plane_wave(
        c, n_end, centers, radii, alpha, beta, kw, direction,
        has_uin=uin is not None, has_grad=uin_grad is not None,
    )


def _radial_rows_scaled(c, n_end, radii, k, eta, alpha, beta):
    """Scale-compensated radial rows: three (mantissa, exponent) pairs.

    sing = alpha h_n + beta k h_n', reg = alpha j_n + beta k j_n',
    blc = i k^{d-2} rho^{d-1} (k j_n' - i eta j_n), each as mant * exp(e)
    with the exponents of the two terms of each sum folded at their
    maximum.  radii/alpha/beta [K, B], k/eta [K]; outputs [K, B, H].
    """
    d = c.c_ndim
    n_idx = torch.as_tensor(basis(c, n_end).n_root, dtype=torch.long, device=radii.device)
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


@dataclass(frozen=True)
class PairRouting:
    """Compacted pair lanes of the factored matvec (see `_pair_routing`)."""

    uniq: np.ndarray  # [NO, d] offset vector per slot (unit dummies pad)
    lane: np.ndarray  # [L] padded lane index slot * 2 p_max + p of each lane
    src: np.ndarray  # [L] source row of [z; z*pm]: b' or B + b
    dst: np.ndarray  # [L] destination ball
    dn: np.ndarray  # [L] bool: mirror lane (parity applied to its output)
    slot_ptr: np.ndarray  # [NO + 1] lanes of each slot (CSR over lanes)
    p_max: int
    uniq_r: np.ndarray  # [NR] distinct pair distances
    g_max: int  # offset slots per distance

    @property
    def rad_ptr(self):
        """[NR + 1] lanes of each radius: its g_max slots are contiguous."""
        return self.slot_ptr[:: self.g_max]


def _pair_routing(centers_np):
    """Host-side pair routing for the factored matvec (radius slots).

    The b < b' offset vectors are deduplicated and ordered by |t|; each
    distinct radius owns g_max offset SLOTS (dummy slots route nothing),
    so the coaxial factor applies per contiguous radius group.  In the
    padded layout of the JAX package lane i = slot * 2 p_max + p: the
    first p_max lanes of a slot hold its b < b' pairs, the next p_max
    their mirrors.  Only the lanes that route a pair are kept, in that
    order: every slot's lanes, and every radius's, form one contiguous
    segment (`slot_ptr`, `rad_ptr`).  Integer index tables replace the
    JAX package's one-hot gather/scatter matrices.
    """
    n_balls = centers_np.shape[0]
    bu, bv = np.triu_indices(n_balls, k=1)
    t_np = np.round(centers_np[bu] - centers_np[bv], 12)
    uniq, inv = np.unique(t_np, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    groups = [np.nonzero(inv == o)[0] for o in range(len(uniq))]
    r_np = np.round(np.linalg.norm(uniq, axis=1), 10)
    uniq_r, r_inv = np.unique(r_np, return_inverse=True)
    n_rad = len(uniq_r)
    g_max = int(np.max(np.bincount(r_inv)))
    slot_uniq = np.zeros((n_rad * g_max, uniq.shape[1]))
    # dummy direction: the radius along the first axis
    slot_uniq[:, 0] = np.repeat(uniq_r, g_max)
    slot_groups = [np.zeros((0,), np.int64)] * (n_rad * g_max)
    fill = np.zeros(n_rad, np.int64)
    for o in range(len(uniq)):
        r = r_inv[o]
        s = r * g_max + fill[r]
        fill[r] += 1
        slot_uniq[s] = uniq[o]
        slot_groups[s] = groups[o]
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


@lru_cache(maxsize=4)
def _rotation_stack(c, n_end, uniq_bytes, n_slots, dtype, device):
    """Packed rotation blocks D [NO] (k-independent), cached per geometry."""
    t_vec = torch.as_tensor(
        np.frombuffer(uniq_bytes, dtype=np.float64).reshape(n_slots, -1).copy(),
        dtype=dtype, device=device,
    )
    t_hat = t_vec / torch.linalg.vector_norm(t_vec, dim=-1, keepdim=True)
    d_rot = rotation_matrix(c, t_hat, n_end)  # [NO, H, H]
    return pack(d_rot, 2 * np.arange(n_end) + 1)


def _factored_operator(c, n_end, centers_np, radii, k, eta, alpha, beta):
    """The factored matrix-free operator: (mv, diag) on [K, B*H] vectors."""
    h_num = basis(c, n_end).num
    n_balls = centers_np.shape[0]
    n_k = k.shape[0]
    dev, rdt = radii.device, radii.dtype
    (sing_m, e_s), (reg_m, e_r), (blc_m, e_b) = _radial_rows_scaled(
        c, n_end, radii, k, eta, alpha, beta
    )
    # the diagonal entry is physically bounded; its factors are not
    diag = (sing_m * blc_m) * torch.exp(e_s + e_b)
    e_r_max = e_r.amax(dim=-2)  # [K, H]
    e_b_max = e_b.amax(dim=-2)
    reg_row = reg_m * torch.exp(e_r - e_r_max[:, None, :])
    blc_col = blc_m * torch.exp(e_b - e_b_max[:, None, :])

    routing = _pair_routing(centers_np)
    n_slots = len(routing.uniq)
    route = make_route(routing.src, routing.dst, routing.dn, n_balls, dev)
    d_seg = LaneSegments(tuple(int(v) for v in routing.slot_ptr))
    x_seg = LaneSegments(tuple(int(v) for v in routing.rad_ptr))

    # the coaxial factor with the degree-level fold of the ball-max
    # exponents (constant on degree blocks, which D preserves:
    # F .* (D X D^H) = D (F .* X) D^H), packed into its child-state
    # blocks: K5 + K2, no [K, NR, H, H] tensor
    n_root = basis(c, n_end).n_root
    starts = torch.as_tensor(np.searchsorted(n_root, np.arange(n_end)), device=dev)
    x_blocks = coax_fold_packed(
        c, n_end, torch.as_tensor(routing.uniq_r, dtype=rdt, device=dev), k,
        e_r_max[:, starts].contiguous(), e_b_max[:, starts].contiguous(),
    )
    d_blocks = _rotation_stack(
        c, n_end, routing.uniq.astype(np.float64).tobytes(), n_slots, rdt, dev
    )
    pm = torch.as_tensor((-1.0) ** (n_root % 2), dtype=rdt, device=dev)
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


def _auto_is_matfree(centers_np, n_balls, n_sys, rdt, device):
    """biem_helmholtz_sphere_tpu's auto policy: True where it picks the
    unique-offset matrix-free GMRES (accelerators: LU up to 6144
    unknowns, dense up to 6 GB; CPU: 12288 and 40 GB)."""
    accel = device.type != "cpu"
    dense_bytes = (2 if rdt == torch.float32 else 4) * 4 * n_sys * n_sys
    if dense_bytes > (6e9 if accel else 40e9):
        return True
    if 8 <= n_balls < 64 and n_sys > (6144 if accel else 12288):
        bu, bv = np.triu_indices(n_balls, k=1)
        n_uniq = len(np.unique(np.round(centers_np[bu] - centers_np[bv], 12), axis=0))
        return n_uniq * 2 <= n_balls * (n_balls - 1) // 2
    return False


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
    solver="auto",
    stable=None,
    density0=None,
):
    """Solve the Helmholtz BIEM for non-overlapping spheres.

    Same parameters, shapes and result as biem_helmholtz_sphere_tpu's
    `biem` ([..., B, d] centers, [..., B] radii, [...] k with at most one
    batch axis here, [...(,B)] alpha/beta, [...] eta); complex outputs are
    native torch complex tensors on the device of the input tensors; with
    no tensor input (numpy or Python numbers) the solve runs on the card,
    and raises where CUDA is absent.  Only the scale-compensated factored
    matrix-free route is ported: a 3D 'b'-rooted tree, B >= 2, stable=True
    (the default in float32), a plane-wave incident field and
    solver="matfree" (or "auto" where the JAX package's policy picks the
    matrix-free solve, as at the 16-sphere n_end=32 bench configuration).
    Every other route raises NotImplementedError.  density0 warm-starts
    GMRES.

    The reference README problem (two sound-soft unit spheres at
    (0, +-2, 0), k=1, plane wave along x0) on the factored route:

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
    ...             n_end=6, uin=uin, solver="matfree", stable=True)
    >>> print(f"{complex(calc.uscat(torch.zeros(3, 1, **f64))[0]):.5f}")
    -0.74133-0.66966j
    """
    if solver not in ("auto", "direct", "gmres", "matfree"):
        raise ValueError(f"unknown solver {solver!r}")
    centers, radii, k, eta, alpha, beta, rdt = _check_biem_inputs(
        c, centers, radii, k, eta, alpha, beta
    )
    if stable is None:
        stable = rdt == torch.float32
    if c.c_ndim < 3 or c.root.kind != "b":
        raise NotImplementedError(
            f"only 'b'-rooted trees in d >= 3 are ported (got "
            f"{c.branching_types_expression_str!r}); {_TREES}"
        )
    n_balls = radii.shape[-1]
    h_num = basis(c, n_end).num
    n_sys = n_balls * h_num
    if uin is None and uin_grad is None:
        raise NotImplementedError(
            f"a solve without an incident field (matrix only) is {_ROUTES}"
        )
    if bool((alpha != 0).any()) and uin is None:
        raise ValueError(
            "alpha is not zero, but uin is None. uin must be provided to "
            "compute the boundary condition."
        )
    if bool((beta != 0).any()) and uin_grad is None:
        raise ValueError(
            "beta is not zero, but uin_grad is None. uin_grad must be "
            "provided to compute the boundary condition."
        )
    centers_np = centers.detach().cpu().numpy().astype(np.float64)
    flat = centers_np.reshape((-1,) + centers_np.shape[-2:])
    if not (flat == flat[:1]).all():
        raise NotImplementedError(
            f"geometry that varies along the batch axis is {_ROUTES}"
        )
    centers_np = flat[0]
    if n_balls < 2 or n_balls >= 64 or force_matrix or not stable:
        route = (
            "the single-sphere diagonal solve" if n_balls < 2
            else "the lattice-FFT operator" if n_balls >= 64
            else "the dense matrix" if force_matrix
            else "the unscaled (stable=False) operator"
        )
        raise NotImplementedError(f"{route} is not ported yet ({_ROUTES})")
    if solver != "matfree" and not (
        solver == "auto"
        and _auto_is_matfree(centers_np, n_balls, n_sys, rdt, radii.device)
    ):
        raise NotImplementedError(
            f"solver={solver!r} selects the direct/dense-GMRES route here, which "
            f"is not ported yet ({_ROUTES}); pass solver='matfree'"
        )
    if k.ndim > 1:
        raise NotImplementedError("at most one batch axis is ported")

    batch = tuple(k.shape)
    n_k = max(1, k.numel())
    k_f = k.to(rdt).reshape(n_k)
    eta_f = eta.expand(batch).reshape(n_k)
    radii_f = radii.to(rdt).expand(batch + (n_balls,)).reshape(n_k, n_balls)
    alpha_f = alpha.expand(batch + (n_balls,)).reshape(n_k, n_balls)
    beta_f = beta.expand(batch + (n_balls,)).reshape(n_k, n_balls)
    centers_t = torch.as_tensor(centers_np, dtype=rdt, device=radii.device)

    f_exp = _rhs_dispatch(
        c, n_end, centers_t, radii_f, alpha_f, beta_f, uin, uin_grad, n_k
    )
    mv, diag = _factored_operator(
        c, n_end, centers_np, radii_f, k_f, eta_f, alpha_f, beta_f
    )
    x0 = None
    if density0 is not None:
        x0 = torch.as_tensor(density0, device=radii.device).to(diag.dtype)
        x0 = x0.expand(batch + (n_balls, h_num)).reshape(n_k, n_sys)
    density, relres, iters = gmres_solve_op(
        mv, diag, f_exp.reshape(n_k, n_sys), x0=x0
    )

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
        density=density.reshape(batch + (n_balls, h_num)),
        uin=uin_wrapped,
        n_end=n_end,
        kind=kind,
        relres=relres.reshape(batch),
        iters=iters.reshape(batch),
    )
