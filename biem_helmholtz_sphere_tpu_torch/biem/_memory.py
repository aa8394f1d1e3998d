"""Peak-memory planning for the BIEM assembly.

The JAX package's `max_memory`/`max_n_end` (the reference's formula),
including its quirk of counting matrix entries for d <= 3 but bytes (x16)
for d > 3.
"""

from ..harmonics._index import harm_n_ndim_le

_COMPLEX128_SIZE = 16


def max_memory(*, c_ndim, n_end, n_balls):
    """Peak memory of assembly as a function of problem size.

    Matrix entries for c_ndim <= 3 (not bytes), bytes beyond.

    >>> max_memory(c_ndim=3, n_end=6, n_balls=2)  # (2*36)^2
    5184
    >>> max_memory(c_ndim=2, n_end=4, n_balls=3)  # (3*7)^2
    441
    """
    if c_ndim <= 3:
        return n_balls**2 * harm_n_ndim_le(n_end, c_ndim) ** 2

    def inner(c_ndim, n_end):
        return (2 * n_end - 1) * n_end ** (c_ndim - 1)

    return (
        n_balls**2
        * inner(c_ndim, n_end) ** 2
        * inner(c_ndim, 2 * n_end)
        * _COMPLEX128_SIZE
    )


def max_n_end(*, c_ndim, memory_limit, n_balls):
    """Largest n_end whose predicted footprint fits in memory_limit.

    >>> max_n_end(c_ndim=3, memory_limit=5184, n_balls=2)
    6
    >>> max_n_end(c_ndim=3, memory_limit=5183, n_balls=2)
    5
    """
    i = 0
    for i in range(1000):
        if max_memory(c_ndim=c_ndim, n_end=i, n_balls=n_balls) > memory_limit:
            break
    return i - 1
