"""Cartesian <-> polyspherical transforms over a branching tree.

Spherical mappings are dicts {node_id: angle tensor, "r": radius tensor};
cartesian tensors put the vector axis FIRST: shape [c_ndim, ...], as in
biem_helmholtz_sphere_tpu.coords._transform.
"""

import torch


def to_cartesian(c, spherical, include_r=True):
    """Map angles (+ optional radius) to cartesian coordinates [c_ndim, ...].

    If "r" is missing or include_r is False, points are on the unit sphere.
    """
    r = spherical.get("r") if include_r else None
    factors = {}  # axis -> list of multiplicative terms

    def walk(node, prefix):
        if node.kind == "a":
            phi = spherical[node.nid]
            factors[node.axes[0]] = prefix + [torch.cos(phi)]
            factors[node.axes[1]] = prefix + [torch.sin(phi)]
            return
        th = spherical[node.nid]
        if node.kind in ("b", "bp"):
            factors[node.axis] = prefix + [torch.cos(th)]
            walk(node.children[0], prefix + [torch.sin(th)])
            return
        walk(node.children[0], prefix + [torch.cos(th)])
        walk(node.children[1], prefix + [torch.sin(th)])

    walk(c.root, [] if r is None else [r])
    parts = []
    for axis in range(c.c_ndim):
        v = factors[axis][0]
        for t in factors[axis][1:]:
            v = v * t
        parts.append(v)
    return torch.stack(torch.broadcast_tensors(*parts), dim=0)


def from_cartesian(c, x):
    """Map cartesian [c_ndim, ...] to {node_id: angle, "r": radius}."""
    if x.shape[0] != c.c_ndim:
        raise ValueError(
            f"leading axis of x must be c_ndim={c.c_ndim}, got {x.shape[0]}"
        )
    out = {}

    def walk(node):
        """Returns the norm of the node's axes sub-vector."""
        if node.kind == "a":
            xi, xj = x[node.axes[0]], x[node.axes[1]]
            out[node.nid] = torch.atan2(xj, xi)
            return torch.hypot(xi, xj)
        if node.kind in ("b", "bp"):
            rc = walk(node.children[0])
            xa = x[node.axis]
            out[node.nid] = torch.atan2(rc, xa)
            return torch.hypot(rc, xa)
        r1 = walk(node.children[0])
        r2 = walk(node.children[1])
        out[node.nid] = torch.atan2(r2, r1)
        return torch.hypot(r1, r2)

    out["r"] = walk(c.root)
    return out
