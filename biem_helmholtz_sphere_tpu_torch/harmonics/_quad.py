"""Product quadrature on S^{d-1} adapted to a branching tree (host numpy).

The rule is exact for products of harmonics up to total degree `deg`; the
same nodes and weights as biem_helmholtz_sphere_tpu.harmonics._quad.
"""

from functools import lru_cache

import numpy as np

from ..special._quad import gauss_jacobi, uniform_circle


def _node_rule(node, deg):
    """(angles [q], weights [q]) integrating this node's measure exactly
    for harmonic products of total degree <= deg."""
    if node.kind == "a":
        return uniform_circle(deg + 2)
    if node.kind in ("b", "bp"):
        s = node.children[0].sdim
        q = deg // 2 + 2
        t, w = gauss_jacobi(q, (s - 1) / 2.0, (s - 1) / 2.0)
        return np.arccos(t), w
    s1 = node.children[0].sdim
    s2 = node.children[1].sdim
    q = deg // 4 + 2
    u, w = gauss_jacobi(q, (s2 - 1) / 2.0, (s1 - 1) / 2.0)
    th = np.arccos(np.sqrt((1.0 + u) / 2.0))
    return th, w * 2.0 ** (-(s1 + s2) / 2.0 - 1.0)


@lru_cache(maxsize=None)
def sphere_quadrature(c, deg):
    """Product rule over the tree: ({nid: angles [Q]}, weights [Q]).

    sum(weights) = |S^{d-1}|; exact for integrands that are products of
    harmonics with root degrees summing to <= deg.
    """
    nodes = c.nodes
    rules = [_node_rule(node, deg) for node in nodes]
    grids = np.meshgrid(*[r[0] for r in rules], indexing="ij")
    wgrids = np.meshgrid(*[r[1] for r in rules], indexing="ij")
    w = np.ones_like(wgrids[0])
    for wg in wgrids:
        w = w * wg
    spherical = {node.nid: g.reshape(-1) for node, g in zip(nodes, grids)}
    return spherical, w.reshape(-1)
