"""The program of a tree's harmonics: the tables `csrc/harmonics.cuh` reads.

A tree's flat harmonics Y_h (harmonics/_eval.py) are products of one
factor per node, each factor a node "job" (harmonics/_index.py::basis's
`node_jobs`):

  'a'  : e^{i m phi} / sqrt(2 pi)                                job (m,)
  'b'  : (sin th)^{nc} p~_{l-nc}^{(lam,lam)}(cos th)             job (nc, l)
  'c'  : 2^{(n1+n2)/2+(s1+s2)/4+1/2} (cos th)^{n1} (sin th)^{n2}
         p~_j^{(n2+(s2-1)/2, n1+(s1-1)/2)}(cos 2 th)            job (n1, n2, l)

The program holds, as int32 / real tensors on one device:

* `nodes` [n_nodes, 4], children before parents: kind (0 'a', 1 'b'/'bp',
  2 'c'), node id, and for 'a' its two cartesian axes, for 'b'/'bp' its
  child's id and its own axis, for 'c' its two children's ids: the
  cartesian-to-angles map of `coords/_transform.py::from_cartesian`, node
  by node;
* `jobs` [n_jobs, 4], every node's jobs in `basis` order, node by node
  (node ids ascending): the Jacobi family (-1 for 'a'), the recurrence
  steps j (l - nc for 'b', (l - n1 - n2) / 2 for 'c'), and the prefactor's
  powers (nc; n1, n2; m for 'a');
* `coef` [n_coef, 4] the three-term coefficients of every family
  (`special/_jacobi.py::jacobi_recurrence`), step j at `fam[f] + j`:
  (1 / b_{j+1}, -a_j / b_{j+1}, b_j / b_{j+1}, 0), so that
  p_{j+1} = (x c1 + c2) p_j - c3 p_{j-1}, and a row of zeros past the
  last family's (KE loads each step's next row a step ahead); `famr`
  [n_fam, 2] the seed p_0 = 1 / b_0 and the prefactor's constant (the 'c'
  norm, else 1);
* `hjob` [H, n_nodes] the job of each flat harmonic at each node (by node
  id; the child states' jobs `csjob` are its rows): KR's generic instance
  (`csrc/plane_rhs.cu`, trees of more than 4 nodes) evaluates Y_h by it
  from the seeds;
* the map h -> (root job, child state), as K3 walks it: the child states
  `cs` [n_cs, 4] (the root's first job, the number J of its root degrees,
  the offset of its entries in program order, its first root degree l0),
  with the child-state ids of `harmonics/_index.py::_child_states`
  (a tuple of every non-root job, numbered in order of first appearance
  in h); `csjob` [n_cs, n_nodes] each child state's job at each node (the
  root's column is its first root job); `perm` [H] the flat h of each
  program entry (entry woff + j of child state cs is its root degree
  l0 + step j), so that w[..., perm] is the density in program order.

A root 'a' (2D) is one child state whose J = 2 n_end - 1 entries are the
root's jobs.

KE (`csrc/harmonic_eval.cu`) walks the same child states in another order,
its walk (`ke_walk_numpy`), so that each child state's subtree factors and
root seed come from the previous one's by one step at one node.  The
non-root nodes are the walk's levels, children first (level l is node
n_nodes - 1 - l: the reverse of the pre-order ids), level 0 the outermost
loop: an 'a' level runs m = 0, 1, .., M then -1, .., -M (the two chains of
powers of e^{+-i phi}), a 'b' or 'c' level its recurrence steps from 0.
Consecutive child states differ by one step at one level (or, at an 'a'
level, the switch from m = M to m = -1), every level inside it back at its
first value.  The walk's tables:

* `walk` [n_cs, 4]: the level that changes from the previous child state
  (| 256 at the switch to the negative chain; 0 for the first), J, the
  offset of its entries in KE's order, l0;
* `wfam` [n_cs, 4]: the family of the job of levels 0, 1, 2 (-1 for 'a')
  and, last, the first coefficient row of the root's (-1 for a root 'a');
* `wroot` [n_cs, 8] (real): the root family's p0 and prefactor constant
  (famr) and that first row's c1, c2, c3 (then zeros), so that a child
  state's root needs no load that waits on another;
* `wstep` [n_cs, 4]: the job of levels 0, 1, 2 as m ('a') or its
  recurrence steps ('b', 'c');
* `wjob` [n_cs, n_nodes]: the rows of `csjob` in walk order;
* `ke_perm` [H] (int32 on the device): the flat h of each entry in KE's
  order (w[..., ke_perm] is the density as KE reads it);
* `wcs` [H] (int32): the child state (its index in walk order) of each
  entry in KE's order (KR, `csrc/plane_rhs.cu`, starts a thread's run of
  entries there), and `ke_hn` [H, 2] (int32) each entry's flat h and root
  degree n_h (KR's one load for both);
* `shape`: the tree's shape for the kernel, the node kinds in pre-order as
  n_nodes << 8 | sum kind_i << 2 i for trees of at most 4 nodes, else 0
  (the kernel's generic instance).

Built on the host in numpy and cached per (tree, n_end, dtype, device).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..harmonics._index import _child_states, basis
from ..special._jacobi import jacobi_recurrence

KIND_A, KIND_B, KIND_C = 0, 1, 2
_KIND = {"a": KIND_A, "b": KIND_B, "bp": KIND_B, "c": KIND_C}


@dataclass(frozen=True, eq=False)
class HarmonicProgram:
    """The tables of a tree's harmonics on one device (see the module)."""

    n_nodes: int
    h_num: int
    n_cs: int
    root_step: int  # root degrees per recurrence step: 1 'b', 2 'c' (0 'a')
    nodes: torch.Tensor
    jobs: torch.Tensor
    fam: torch.Tensor
    coef: torch.Tensor
    famr: torch.Tensor
    cs: torch.Tensor
    csjob: torch.Tensor
    perm: torch.Tensor
    hjob: torch.Tensor
    # KE's walk (`ke_walk_numpy`)
    shape: int
    walk: torch.Tensor
    wfam: torch.Tensor
    wroot: torch.Tensor
    wstep: torch.Tensor
    wjob: torch.Tensor
    ke_perm: torch.Tensor
    wcs: torch.Tensor
    ke_hn: torch.Tensor


@lru_cache(maxsize=64)
def program_numpy(c, n_end):
    """The program's tables as host numpy (int32 / float64) in a dict."""
    b = basis(c, n_end)
    by_nid = {node.nid: node for node in c.nodes}
    n_nodes = len(c.nodes)

    # children before parents: the reverse of the pre-order node ids
    nodes = []
    for node in reversed(c.nodes):
        if node.kind == "a":
            nodes.append((KIND_A, node.nid, node.axes[0], node.axes[1]))
        elif node.kind in ("b", "bp"):
            nodes.append((KIND_B, node.nid, node.children[0].nid, node.axis))
        else:
            nodes.append((KIND_C, node.nid, node.children[0].nid, node.children[1].nid))

    jobs, job_base = [], np.zeros(n_nodes, dtype=np.int32)
    fam_base, famr, coef = [], [], []
    fam_of = {}

    def family(nid, key, alpha, beta, steps, norm):
        if (nid, key) not in fam_of:
            a, bb = jacobi_recurrence(max(steps, 1), float(alpha), float(beta))
            fam_of[(nid, key)] = len(fam_base)
            fam_base.append(len(coef))
            famr.append((1.0 / bb[0], norm))
            for j in range(max(steps, 1)):
                coef.append((1.0 / bb[j + 1], -a[j] / bb[j + 1], bb[j] / bb[j + 1], 0.0))
        return fam_of[(nid, key)]

    for nid in range(n_nodes):
        node = by_nid[nid]
        node_jobs = b.node_jobs[nid]
        job_base[nid] = len(jobs)
        if node.kind == "a":
            jobs.extend((-1, 0, p[0], 0) for p in node_jobs)
            continue
        if node.kind in ("b", "bp"):
            s = node.children[0].sdim
            top = {}
            for nc, ell in node_jobs:
                top[nc] = max(top.get(nc, 0), ell - nc)
            for nc, ell in node_jobs:
                f = family(nid, nc, nc + (s - 1) / 2.0, nc + (s - 1) / 2.0, top[nc], 1.0)
                jobs.append((f, ell - nc, nc, 0))
            continue
        s1, s2 = node.children[0].sdim, node.children[1].sdim
        top = {}
        for n1, n2, ell in node_jobs:
            top[(n1, n2)] = max(top.get((n1, n2), 0), (ell - n1 - n2) // 2)
        for n1, n2, ell in node_jobs:
            norm = 2.0 ** ((n1 + n2) / 2.0 + (s1 + s2) / 4.0 + 0.5)
            f = family(nid, (n1, n2), n2 + (s2 - 1) / 2.0, n1 + (s1 - 1) / 2.0,
                       top[(n1, n2)], norm)
            jobs.append((f, (ell - n1 - n2) // 2, n1, n2))

    coef.append((0.0, 0.0, 0.0, 0.0))  # read a step ahead by KE, never used
    hjob = np.stack([job_base[nid] + b.node_job_index[nid] for nid in range(n_nodes)],
                    axis=1).astype(np.int32)
    # the map h -> (root job, child state), child states numbered as the
    # coaxial factor's (`_child_states`), each with its h ascending
    root = c.root.nid
    cs_of = _child_states(c, n_end)
    members = np.split(np.argsort(cs_of, kind="stable"), np.cumsum(np.bincount(cs_of))[:-1])
    root_jobs = b.node_jobs[root]
    root_job = b.node_job_index[root]
    cs, csjob, perm = [], [], []
    for hs in members:
        hs = sorted(hs, key=lambda h: root_job[h])  # root jobs of one family by degree
        first = int(root_job[hs[0]])
        p0 = root_jobs[first]
        l0 = 0 if c.root.kind == "a" else p0[-1]
        cs.append((job_base[root] + first, len(hs), len(perm), l0))
        csjob.append(hjob[hs[0]])
        perm.extend(hs)
    kind = _KIND[c.root.kind]
    return dict(
        n_nodes=n_nodes, h_num=b.num, n_cs=len(cs), root_kind=kind,
        root_step={KIND_A: 0, KIND_B: 1, KIND_C: 2}[kind],
        nodes=np.asarray(nodes, dtype=np.int32),
        jobs=np.asarray(jobs, dtype=np.int32),
        fam=np.asarray(fam_base, dtype=np.int32),
        coef=np.asarray(coef, dtype=np.float64).reshape(-1, 4),
        famr=np.asarray(famr, dtype=np.float64).reshape(-1, 2),
        hjob=hjob,
        n_root=np.asarray(b.n_root, dtype=np.int32),
        cs=np.asarray(cs, dtype=np.int32),
        csjob=np.asarray(csjob, dtype=np.int32),
        perm=np.asarray(perm, dtype=np.int64),
    )


def shape_code(c):
    """The tree's shape as KE's kernel instances name it: the node kinds in
    pre-order, n_nodes << 8 | sum kind_i << 2 i, for at most 4 nodes; 0
    (the generic instance) above."""
    if len(c.nodes) > 4:
        return 0
    return len(c.nodes) << 8 | sum(_KIND[n.kind] << 2 * n.nid for n in c.nodes)


@lru_cache(maxsize=64)
def ke_walk_numpy(c, n_end):
    """KE's walk of the child states (see the module) as host numpy."""
    t = program_numpy(c, n_end)
    n_nodes, jobs, csjob, cs = t["n_nodes"], t["jobs"], t["csjob"], t["cs"]
    assert all(ch.nid > n.nid for n in c.nodes for ch in (n.children or ())), "pre-order ids"
    kinds = {nid: kind for kind, nid, _, _ in t["nodes"]}
    levels = [n_nodes - 1 - lv for lv in range(n_nodes - 1)]  # level -> node id

    def key(i):  # per level (m < 0, |m|) for 'a', (0, steps) else
        k = []
        for nid in levels:
            _, steps, p1, _ = jobs[csjob[i, nid]]
            k.append((int(p1 < 0), abs(int(p1))) if kinds[nid] == KIND_A else (0, int(steps)))
        return tuple(k)

    keys = {i: key(i) for i in range(t["n_cs"])}
    order = sorted(range(t["n_cs"]), key=keys.get)
    ops = [0]
    for a, b in zip(order, order[1:]):
        ka, kb = keys[a], keys[b]
        lv = next(i for i in range(len(ka)) if ka[i] != kb[i])
        flip = int(ka[lv][0] == 0 and kb[lv] == (1, 1))
        if not (flip or (ka[lv][0] == kb[lv][0] and kb[lv][1] == ka[lv][1] + 1)) or any(
                kb[i] != (0, 0) for i in range(lv + 1, len(kb))):
            raise AssertionError(f"walk: child states {ka} -> {kb} are not one step apart")
        ops.append(lv | flip << 8)
    if order and any(k != (0, 0) for k in keys[order[0]]):
        raise AssertionError("walk: the first child state is not every level's first")
    walk, wfam, wroot, wstep, ke_perm = [], [], [], [], []
    for e, i in enumerate(order):
        job0, n_j, woff, l0 = (int(v) for v in cs[i])
        walk.append((ops[e], n_j, len(ke_perm), l0))
        ke_perm.extend(t["perm"][woff : woff + n_j])
        f_root = int(jobs[job0][0])
        row = int(t["fam"][f_root]) if f_root >= 0 else -1
        wroot.append((*t["famr"][f_root], *t["coef"][row][:3], 0.0, 0.0, 0.0) if f_root >= 0
                     else (0.0,) * 8)
        fam, step = [-1, -1, -1, row], [0, 0, 0, 0]
        for lv, nid in enumerate(levels[:3]):
            f, steps, p1, _ = jobs[csjob[i, nid]]
            fam[lv] = int(f)
            step[lv] = int(p1) if kinds[nid] == KIND_A else int(steps)
        wfam.append(fam)
        wstep.append(step)
    i32 = np.int32
    return dict(
        shape=shape_code(c),
        walk=np.asarray(walk, dtype=i32).reshape(-1, 4),
        wfam=np.asarray(wfam, dtype=i32).reshape(-1, 4),
        wroot=np.asarray(wroot, dtype=np.float64).reshape(-1, 8),
        wstep=np.asarray(wstep, dtype=i32).reshape(-1, 4),
        wjob=np.ascontiguousarray(csjob[order]).astype(i32),
        ke_perm=np.asarray(ke_perm, dtype=np.int64),
        wcs=np.repeat(np.arange(len(order)), [n_j for _, n_j, _, _ in walk]).astype(i32),
        ke_hn=np.stack([ke_perm, t["n_root"][ke_perm]], axis=1).astype(i32).reshape(-1, 2),
    )


@lru_cache(maxsize=64)
def ke_runs(c, n_end, lanes):
    """KE's few-point lanes: `lanes` + 1 starts of contiguous runs of the
    walk (int32), each of about the same cost (a run's first child state
    rebuilt from its seeds, then one step a child state besides its J root
    steps)."""
    walk = ke_walk_numpy(c, n_end)["walk"]
    cost = np.cumsum(walk[:, 1].astype(np.int64) + 2)
    total = int(cost[-1]) if len(cost) else 0
    starts = np.searchsorted(cost, total * np.arange(1, lanes) / lanes, side="left") + 1
    return np.concatenate([[0], np.minimum(starts, len(walk)), [len(walk)]]).astype(np.int32)


@lru_cache(maxsize=32)
def harmonic_program(c, n_end, dtype, device):
    """The program of (tree, n_end) on `device`, its real tables in the
    real dtype `dtype`; cached."""
    t = dict(program_numpy(c, n_end), **ke_walk_numpy(c, n_end))
    dev = torch.device(device)

    def put(key, dt=torch.int32):
        return torch.as_tensor(t[key], dtype=dt, device=dev).contiguous()

    return HarmonicProgram(
        n_nodes=t["n_nodes"], h_num=t["h_num"], n_cs=t["n_cs"], root_step=t["root_step"],
        nodes=put("nodes"), jobs=put("jobs"), fam=put("fam"),
        coef=put("coef", dtype), famr=put("famr", dtype), cs=put("cs"),
        csjob=put("csjob"), perm=put("perm", torch.int64), hjob=put("hjob"),
        shape=t["shape"], walk=put("walk"), wfam=put("wfam"), wroot=put("wroot", dtype),
        wstep=put("wstep"),
        wjob=put("wjob"), ke_perm=put("ke_perm"), wcs=put("wcs"), ke_hn=put("ke_hn"),
    )
