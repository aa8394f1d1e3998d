r"""Rotation + coaxial (S|R) translation for 'b'-rooted trees.

    SR(t) = D(R) SR_e(|t|) D(R)^H,        R e = t^

*  `SR_e(r)`, translation along the root axis, is block-diagonal over the
   child states; its static tables come from `_coax_tables` and the
   scale-compensated band sum lives in `_scaled.coaxial_scaled`.
*  `D(R)`, the harmonic representation of the rotation R, preserves
   degree (block-diagonal over degrees), is unitary, and is computed
   exactly by quadrature: D[h',h] = sum_q w_q conj(Y_{h'}(s_q))
   Y_h(R^{-1} s_q), with a rule exact to degree 2(n_end-1).

The same math as biem_helmholtz_sphere_tpu.translation._rotation; the
host tables are numpy float64, built once per (tree, n_end) and cached.
"""

from functools import lru_cache

import numpy as np
import torch

from ..coords import from_cartesian, to_cartesian
from ..harmonics._eval import _node_table, harmonics
from ..harmonics._index import basis
from ..harmonics._quad import _node_rule, sphere_quadrature
from ._ops import _surface_area


def _root_axis(c):
    if c.root.kind not in ("b", "bp"):
        raise NotImplementedError(
            "rotation translation requires a 'b'/'bp'-rooted tree "
            f"(got {c.root.kind!r}); other trees are ROADMAP queue 1 item 9"
        )
    return c.root.axis


@lru_cache(maxsize=32)
def _coax_tables(c, n_end):
    """Static numpy tables for the coaxial factor.

    Returns (zf [NB] zonal prefactors, w [q] quadrature weights,
    tz [q, NB] zonal root factors, t_cols [q, H] root factors per
    harmonic, ell [H] root degree, cs [H] child-state id).
    """
    b = basis(c, n_end)
    root = c.root
    nid = root.nid
    jobs = b.node_jobs[nid]
    th, w = _node_rule(root, 4 * (n_end - 1) + 2)
    th_t = torch.as_tensor(th, dtype=torch.float64)
    t_tab = _node_table(root, jobs, {nid: th_t}).numpy()  # [q, J]
    # child-state id: tuple of all non-root jobs
    nids = [n.nid for n in c.nodes if n.nid != nid]
    keys = {}
    cs = np.empty(b.num, dtype=np.int64)
    for h in range(b.num):
        key = tuple(int(b.node_job_index[i][h]) for i in nids)
        cs[h] = keys.setdefault(key, len(keys))
    ell = np.array([jobs[j][1] for j in b.node_job_index[nid]], dtype=np.int64)

    # zonal bands: root jobs (0, n'') for n'' < 2 n_end - 1
    b2 = basis(c, 2 * n_end - 1)
    jobs2 = b2.node_jobs[nid]
    zsel = [(i, p[1]) for i, p in enumerate(jobs2) if p[0] == 0]
    zidx = np.array([i for i, _ in sorted(zsel, key=lambda t: t[1])])
    tz = _node_table(root, jobs2, {nid: th_t}).numpy()[:, zidx]
    tz0 = _node_table(
        root, jobs2, {nid: torch.zeros(1, dtype=torch.float64)}
    ).numpy()[0, zidx]
    omega_child = _surface_area(root.children[0].sdim + 1)
    zf = tz0 / omega_child
    t_cols = t_tab[:, b.node_job_index[nid]]  # [q, H]
    return zf, w, tz, t_cols, ell, cs


@lru_cache(maxsize=256)
def _degree_groups(c, n_end, target=128):
    """Contiguous [start, stop) row groups aligned to root-degree-block
    boundaries, each <= target rows where block sizes allow (a single
    block larger than target becomes its own group)."""
    n_root = np.asarray(basis(c, n_end).n_root)
    bounds = [0] + [
        i for i in range(1, len(n_root)) if n_root[i] != n_root[i - 1]
    ] + [len(n_root)]
    groups = []
    start = 0
    for bi in range(1, len(bounds) - 1):
        if bounds[bi + 1] - start > target and bounds[bi] > start:
            groups.append((start, bounds[bi]))
            start = bounds[bi]
    groups.append((start, bounds[-1]))
    return tuple(groups)


@lru_cache(maxsize=32)
def _rot_tables(c, n_end):
    """Quadrature weights [Q], conj(Y) [Q, H] (complex128), unit points
    [d, Q] and root degrees [H], as host numpy."""
    sph, w = sphere_quadrature(c, 2 * (n_end - 1))
    sph_t = {key: torch.as_tensor(v, dtype=torch.float64) for key, v in sph.items()}
    y = harmonics(c, sph_t, n_end)
    s_cart = to_cartesian(c, sph_t, include_r=False)
    return (
        w,
        y.conj().resolve_conj().numpy(),
        s_cart.numpy(),
        np.asarray(basis(c, n_end).n_root, dtype=np.int64),
    )


def _rotation_to_axis(t_hat, axis, d):
    """R with R e_axis = t_hat, as a [..., d, d] matrix (Rodrigues in the
    plane span(e_axis, t_hat); safe at t_hat = +-e_axis)."""
    kw = dict(dtype=t_hat.dtype, device=t_hat.device)
    e = torch.zeros(d, **kw)
    e[axis] = 1.0
    ct = t_hat[..., axis]
    v = t_hat - ct[..., None] * e
    s = torch.linalg.norm(v, dim=-1)
    safe = s > 1e-7
    v_hat = torch.where(
        safe[..., None], v / torch.where(safe, s, torch.ones_like(s))[..., None],
        torch.zeros_like(v),
    )
    eye = torch.eye(d, **kw)
    uu = e[:, None] * e[None, :]
    vv = v_hat[..., :, None] * v_hat[..., None, :]
    vu = v_hat[..., :, None] * e[None, :]
    uv = e[:, None] * v_hat[..., None, :]
    r = eye + (ct[..., None, None] - 1.0) * (uu + vv) + s[..., None, None] * (vu - uv)
    # t_hat ~ -e: rotate by pi in the (e, e_other) plane
    anti = (~safe) & (ct < 0)
    other = (axis + 1) % d
    flip = torch.eye(d, **kw)
    flip[axis, axis] = -1.0
    flip[other, other] = -1.0
    r = torch.where(anti[..., None, None], flip, r)
    # t_hat ~ +e: identity
    return torch.where(((~safe) & (ct >= 0))[..., None, None], eye, r)


def rotation_blocks(c, t_hat, n_end):
    """D(R) as degree-group diagonal blocks: (groups, [complex [..., g, g]]).

    Within a group that spans several degree blocks the quadrature's ~eps
    off-block residue is masked to exact zeros: sandwiched against coax
    blocks of magnitude |h_{n+n'}(kr)| it would leak huge-scale roundoff
    into low-degree entries (0.23 relative error in float32 at n_end=10).
    """
    d = c.c_ndim
    axis = _root_axis(c)
    w, yc, s_cart, n_root = _rot_tables(c, n_end)
    kw = dict(dtype=t_hat.dtype, device=t_hat.device)
    cdt = torch.complex128 if t_hat.dtype == torch.float64 else torch.complex64
    w = torch.as_tensor(w, **kw)
    yc = torch.as_tensor(yc, dtype=cdt, device=t_hat.device)
    s_cart = torch.as_tensor(s_cart, **kw)
    r = _rotation_to_axis(t_hat, axis, d)  # [..., d, d]
    s_rot = torch.einsum("...ij,iq->...jq", r, s_cart)  # R^T s
    sph_rot = from_cartesian(c, torch.movedim(s_rot, -2, 0))
    y_rot = harmonics(c, sph_rot, n_end)  # [..., Q, H]
    ycw = yc * w[:, None]
    groups = _degree_groups(c, n_end)
    blocks = []
    for s, e in groups:
        dmat_g = torch.einsum("qa,...qb->...ab", ycw[:, s:e], y_rot[..., s:e])
        nr_g = n_root[s:e]
        if nr_g[0] != nr_g[-1]:  # group spans several degree blocks
            same = torch.as_tensor(nr_g[:, None] == nr_g[None, :], device=t_hat.device)
            dmat_g = torch.where(same, dmat_g, 0.0)
        blocks.append(dmat_g)
    return groups, blocks


def rotation_matrix(c, t_hat, n_end):
    """D(R)[..., h', h] with R e_root = t_hat: unitary, degree-block-
    diagonal, exact zeros off the degree groups."""
    groups, blocks = rotation_blocks(c, t_hat, n_end)
    h_num = groups[-1][1]
    out = blocks[0].new_zeros(blocks[0].shape[:-2] + (h_num, h_num))
    for (s, e), blk in zip(groups, blocks):
        out[..., s:e, s:e] = blk
    return out
