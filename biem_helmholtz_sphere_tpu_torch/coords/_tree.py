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
the same grammar and node/axis numbering as
biem_helmholtz_sphere_tpu.coords._tree.
"""

from dataclasses import dataclass, field


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
