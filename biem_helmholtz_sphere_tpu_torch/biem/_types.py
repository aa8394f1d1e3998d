"""Typing surface parity with the reference (_biem.py:77-193).

`BIEMKwargs`, `UinCallable`, `BIEMResultCalculatorProtocol` mirror the
reference's TypedDict/Protocol so downstream code written against the
reference's types ports over unchanged.
"""

from typing import Any, Literal, NotRequired, Protocol, TypedDict, runtime_checkable


class BIEMKwargs(TypedDict):
    """Keyword arguments of `biem` (reference: _biem.py:77-101)."""

    centers: Any
    radii: Any
    k: Any
    n_end: int
    eta: NotRequired[Any]
    kind: NotRequired[Literal["inner", "outer"]]
    force_matrix: NotRequired[bool]
    solver: NotRequired[Literal["auto", "direct", "gmres", "matfree"]]
    stable: NotRequired[bool | None]


@runtime_checkable
class UinCallable(Protocol):
    """Incident-field callable (reference: _biem.py:104-128)."""

    def __call__(self, x, /, *, expand_x: bool = True): ...


@runtime_checkable
class BIEMResultCalculatorProtocol(Protocol):
    """Solved-state protocol (reference: _biem.py:131-193)."""

    c: Any
    uin: Any
    centers: Any
    radii: Any
    k: Any
    n_end: int
    eta: Any
    kind: str
    density: Any
    matrix: Any
    # iterative-solver convergence diagnostics (None for direct solves;
    # extension over the reference, whose direct solve needed none)
    relres: Any
    iters: Any

    def uscat(self, x, /, far_field=False, per_ball=False, expand_x=True): ...
