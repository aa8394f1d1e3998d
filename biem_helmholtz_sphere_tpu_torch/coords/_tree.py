"""Polyspherical coordinate trees (Vilenkin branching trees).

A coordinate system on S^{d-1} is a rooted tree whose nodes are

  'a'  : a circle S^1 (two cartesian axes; angle phi in [0, 2pi))
  'b'  : one new cartesian axis + a subtree; x_axis = cos(theta),
         subtree scaled by sin(theta); theta in [0, pi]; axis placed
         AFTER the subtree's axes
  'bp' : like 'b' but with the new axis placed BEFORE the subtree's axes
  'c'  : two subtrees; first scaled by cos(theta), second by sin(theta);
         theta in [0, pi/2]; axes concatenated (first then second)

Branching-type strings are parsed with 'b'+optional 'p' taking one
subtree, 'c' taking two, 'a' terminal: "a" (2D), "ba"/"bpa" (3D),
"bba"/"bpbpa"/"caa" (4D).  The tree is a frozen, hashable Python
structure, so it keys the host-side table caches.  Host Python only:
the same grammar, node/axis numbering and `create_*` constructors as
biem_helmholtz_sphere_tpu.coords._tree (`create_random` draws the same
tree from the same seed).
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Node:
    """One tree node; `nid` indexes the node's angle in spherical mappings."""

    kind: str  # 'a' | 'b' | 'bp' | 'c'
    children: tuple = ()
    nid: int = -1
    axes: tuple = ()  # cartesian axes covered by this node's subtree
    sdim: int = 0  # the subtree covers the sphere S^{sdim}

    @property
    def axis(self):
        """For 'b'/'bp': the cartesian axis carrying cos(theta)."""
        if self.kind == "b":
            return self.axes[-1]
        if self.kind == "bp":
            return self.axes[0]
        raise ValueError(f"node kind {self.kind} has no distinguished axis")


def _parse(s, pos):
    ch = s[pos]
    if ch == "a":
        return ("a", ()), pos + 1
    if ch == "b":
        if pos + 1 < len(s) and s[pos + 1] == "p":
            child, rest = _parse(s, pos + 2)
            return ("bp", (child,)), rest
        child, rest = _parse(s, pos + 1)
        return ("b", (child,)), rest
    if ch == "c":
        c1, rest = _parse(s, pos + 1)
        c2, rest = _parse(s, rest)
        return ("c", (c1, c2)), rest
    raise ValueError(f"invalid branching type character {ch!r} in {s!r}")


def _build(spec, next_nid, next_axis):
    """Assign node ids (pre-order) and cartesian axes; returns (Node, nid, axis)."""
    kind, children_spec = spec
    nid = next_nid
    next_nid += 1
    if kind == "a":
        axes = (next_axis, next_axis + 1)
        return Node("a", (), nid, axes, 1), next_nid, next_axis + 2
    if kind in ("b", "bp"):
        child, next_nid, next_axis = _build(children_spec[0], next_nid, next_axis)
        ax = next_axis
        next_axis += 1
        axes = child.axes + (ax,) if kind == "b" else (ax,) + child.axes
        return Node(kind, (child,), nid, axes, child.sdim + 1), next_nid, next_axis
    c1, next_nid, next_axis = _build(children_spec[0], next_nid, next_axis)
    c2, next_nid, next_axis = _build(children_spec[1], next_nid, next_axis)
    return (
        Node("c", (c1, c2), nid, c1.axes + c2.axes, c1.sdim + c2.sdim + 1),
        next_nid,
        next_axis,
    )


@dataclass(frozen=True)
class SphericalCoordinates:
    """A polyspherical coordinate system on S^{c_ndim - 1} (hashable)."""

    root: Node
    branching_types_expression_str: str = field(default="")

    @property
    def c_ndim(self):
        return self.root.sdim + 1

    @property
    def s_ndim(self):
        """Number of angles (= number of nodes)."""
        return len(self.nodes)

    @property
    def nodes(self):
        out = []

        def walk(node):
            out.append(node)
            for ch in node.children:
                walk(ch)

        walk(self.root)
        return tuple(out)

    def node_by_id(self, nid):
        """The node whose id is nid; KeyError when the tree has none."""
        for node in self.nodes:
            if node.nid == nid:
                return node
        raise KeyError(nid)

    def draw(self, ax=None):
        """Draw the coordinate tree on a matplotlib axes (a new figure's
        when ax is None); returns the axes.  Each node is a dot labelled
        kind + node id."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        pos = {}
        labels = {}

        def walk(node, depth, x0, x1):
            x = 0.5 * (x0 + x1)
            pos[node.nid] = (x, -depth)
            labels[node.nid] = f"{node.kind}{node.nid}"
            n = len(node.children)
            for i, ch in enumerate(node.children):
                cx0 = x0 + (x1 - x0) * i / n
                cx1 = x0 + (x1 - x0) * (i + 1) / n
                ax.plot([x, 0.5 * (cx0 + cx1)], [-depth, -(depth + 1)], "k-", lw=1)
                walk(ch, depth + 1, cx0, cx1)

        walk(self.root, 0, 0.0, 1.0)
        for nid, (x, y) in pos.items():
            ax.plot([x], [y], "o", ms=14, color="#4c72b0")
            ax.annotate(labels[nid], (x, y), ha="center", va="center", color="w", fontsize=8)
        ax.set_axis_off()
        return ax


def create_from_branching_types(s):
    """Build coordinates from a branching-type string such as "ba" or "caa".

    >>> create_from_branching_types("ba").c_ndim  # 3D spherical
    3
    >>> c = create_from_branching_types("caa")  # 4D, "c" splits 2+2
    >>> c.c_ndim, c.s_ndim
    (4, 3)
    >>> create_from_branching_types("xy")
    Traceback (most recent call last):
        ...
    ValueError: invalid branching type character 'x' in 'xy'
    """
    spec, rest = _parse(s, 0)
    if rest != len(s):
        raise ValueError(f"trailing characters in branching type string {s!r}")
    root, _, _ = _build(spec, 0, 0)
    return SphericalCoordinates(root=root, branching_types_expression_str=s)


def create_standard(c_ndim):
    """Standard hyperspherical coordinates: "b"*(d-2) + "a"."""
    if c_ndim < 2:
        raise ValueError("c_ndim must be >= 2")
    return create_from_branching_types("b" * (c_ndim - 2) + "a")


def create_standard_prime(c_ndim):
    """Primed standard coordinates: "bp"*(d-2) + "a"."""
    if c_ndim < 2:
        raise ValueError("c_ndim must be >= 2")
    return create_from_branching_types("bp" * (c_ndim - 2) + "a")


def create_hopf(c_ndim):
    """Hopf coordinates: "c" splits in halves down to circles; c_ndim must
    be a power of two."""
    if c_ndim < 2 or (c_ndim & (c_ndim - 1)) != 0:
        raise ValueError("Hopf coordinates require c_ndim a power of 2")

    def rec(d):
        if d == 2:
            return "a"
        return "c" + rec(d // 2) + rec(d // 2)

    return create_from_branching_types(rec(c_ndim))


def create_random(c_ndim, rng=None):
    """A random valid branching tree of the given dimension; rng is a seed
    or a numpy Generator (`np.random.default_rng`), drawn from in the same
    order as the JAX package's, so one seed gives one tree in both."""
    rng = np.random.default_rng(rng)

    def rec(d):
        if d == 2:
            return "a"
        if d == 3:
            return rng.choice(["b", "bp"]) + rec(2)
        kind = rng.choice(["b", "bp", "c"])
        if kind in ("b", "bp"):
            return kind + rec(d - 1)
        d1 = int(rng.integers(2, d - 1))
        return "c" + rec(d1) + rec(d - d1)

    return create_from_branching_types(rec(c_ndim))
