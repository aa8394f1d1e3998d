"""Flat enumeration of hyperspherical harmonics over a branching tree.

Host numpy, transliterated from biem_helmholtz_sphere_tpu.harmonics._index:
every (tree, n_end) pair gets a flat enumeration precomputed and cached,
in the same order, so the two packages index harmonics identically.

Quantum numbers per node kind:
  'a'  : m in {-(n_end-1), ..., n_end-1}; node degree |m|
  'b'  : l = node degree, n_child <= l < n_end
  'c'  : l = node degree, l = n1 + n2 + 2j <= n_end - 1, j >= 0
"""

from dataclasses import dataclass
from functools import lru_cache
from math import comb

import numpy as np


def harm_n_ndim(n, c_ndim):
    """dim H_n(S^{c_ndim-1}) = C(n+d-2, d-2) + C(n+d-3, d-2)."""
    d = c_ndim
    return comb(n + d - 2, d - 2) + (comb(n + d - 3, d - 2) if n >= 1 else 0)


def harm_n_ndim_le(n_end, c_ndim):
    """Number of harmonics with degree < n_end (reference:
    ush.harm_n_ndim_le, used by the memory model at _biem.py:44).

    >>> harm_n_ndim_le(6, 3)  # 3D: n_end^2
    36
    >>> harm_n_ndim_le(4, 2)  # 2D: 2*n_end - 1
    7
    >>> harm_n_ndim_le(3, 4)  # 4D: sum of (n+1)^2
    14
    """
    return sum(harm_n_ndim(n, c_ndim) for n in range(n_end))


def _enumerate(node, n_end):
    """List of (degree, {nid: params}) for the subtree, any order."""
    if node.kind == "a":
        out = []
        for m in range(-(n_end - 1), n_end):
            out.append((abs(m), {node.nid: (m,)}))
        return out
    if node.kind in ("b", "bp"):
        sub = _enumerate(node.children[0], n_end)
        out = []
        for nc, params in sub:
            for ell in range(nc, n_end):
                out.append((ell, {**params, node.nid: (nc, ell)}))
        return out
    # 'c'
    s1 = _enumerate(node.children[0], n_end)
    s2 = _enumerate(node.children[1], n_end)
    out = []
    for n1, p1 in s1:
        for n2, p2 in s2:
            for ell in range(n1 + n2, n_end, 2):
                out.append((ell, {**p1, **p2, node.nid: (n1, n2, ell)}))
    return out


@dataclass(frozen=True, eq=False)
class HarmonicBasis:
    """Static indexing tables for all harmonics of degree < n_end on a tree.

    Attributes
    ----------
    c, n_end : the tree and degree cutoff
    num : number of flat harmonics (= harm_n_ndim_le(n_end, c.c_ndim))
    n_root : [num] int, root degree per flat harmonic
    conj_index : [num] int, flat index of the conjugate harmonic
        (conj(Y_h) = Y_{conj_index[h]}; all a-node m's negated)
    node_jobs : {nid: list of param tuples}, the distinct 1-D factor
        evaluations each node must provide
    node_job_index : {nid: [num] int}, which job each flat harmonic uses
    """

    c: object
    n_end: int
    num: int
    n_root: np.ndarray
    conj_index: np.ndarray
    node_jobs: dict
    node_job_index: dict

    def __hash__(self):
        return hash((self.c, self.n_end))


@lru_cache(maxsize=None)
def basis(c, n_end):
    """Build (and cache) the flat harmonic enumeration for (tree, n_end)."""
    if n_end < 1:
        raise ValueError("n_end must be >= 1")
    states = _enumerate(c.root, n_end)
    nids = [node.nid for node in c.nodes]
    # Deterministic order: by degree, then per-node params in node order.
    states.sort(key=lambda s: (s[0], tuple(s[1][i] for i in nids)))
    num = len(states)
    expected = harm_n_ndim_le(n_end, c.c_ndim)
    if num != expected:
        raise AssertionError(
            f"enumeration bug: {num} harmonics != closed form {expected}"
        )
    n_root = np.array([s[0] for s in states], dtype=np.int32)

    node_jobs = {}
    node_job_index = {}
    for nid in nids:
        jobs = sorted({s[1][nid] for s in states})
        jidx = {p: i for i, p in enumerate(jobs)}
        node_jobs[nid] = jobs
        node_job_index[nid] = np.array(
            [jidx[s[1][nid]] for s in states], dtype=np.int32
        )

    # conjugation: negate every a-node m
    key_to_idx = {
        tuple(s[1][i] for i in nids): idx for idx, s in enumerate(states)
    }
    kind_by_nid = {node.nid: node.kind for node in c.nodes}
    conj_index = np.empty(num, dtype=np.int32)
    for idx, s in enumerate(states):
        conj_params = []
        for i in nids:
            p = s[1][i]
            conj_params.append((-p[0],) if kind_by_nid[i] == "a" else p)
        conj_index[idx] = key_to_idx[tuple(conj_params)]

    return HarmonicBasis(
        c=c,
        n_end=n_end,
        num=num,
        n_root=n_root,
        conj_index=conj_index,
        node_jobs=node_jobs,
        node_job_index=node_job_index,
    )


def _zonal_jobs(c, n_end):
    """The root's zonal jobs (0, n'') for n'' < 2 n_end - 1, by n'': those
    of `basis(c, 2 n_end - 1)`'s 'b'/'bp' root with nc = 0, without
    enumerating that basis (every child subtree has a degree-0 state, so
    (0, n'') is a root job at every n'' of that basis)."""
    if c.root.kind not in ("b", "bp"):
        raise ValueError(f"zonal jobs need a 'b'/'bp' root (got {c.root.kind!r})")
    return [(0, n) for n in range(2 * n_end - 1)]


@lru_cache(maxsize=64)
def _child_states(c, n_end):
    """[num] int64: the child state of each flat harmonic, the tuple of its
    jobs at every non-root node, numbered in order of first appearance in
    h (the ids of the coaxial factor's blocks and of the harmonic program's
    child states)."""
    b = basis(c, n_end)
    others = [node.nid for node in c.nodes if node.nid != c.root.nid]
    if not others:
        return np.zeros(b.num, dtype=np.int64)
    keys = np.stack([b.node_job_index[i] for i in others], axis=1)
    _, first, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def index_array_harmonics(c, n_end):
    """Root degree per flat harmonic (numpy int32 [num])."""
    return basis(c, n_end).n_root


def assume_n_end_from_num(c, num):
    """Infer n_end from a flat harmonic count (reference:
    ush.assume_n_end_and_include_negative_m_from_harmonics; _biem.py:864)."""
    for n_end in range(1, 20000):
        h = harm_n_ndim_le(n_end, c.c_ndim)
        if h == num:
            return n_end
        if h > num:
            break
    raise ValueError(f"no n_end matches {num} harmonics in d={c.c_ndim}")
